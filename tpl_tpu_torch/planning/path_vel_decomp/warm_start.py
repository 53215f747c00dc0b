"""
Warm-start bookkeeping shared by the RSTP stages.

Every stage keeps its previous solve as the next tick's initial guess;
these helpers decide when that guess is still valid (ResetGate) and
re-index it onto the new arc-length grid after the window slid
(ArcShift). Functional-core idiom: the solver state itself is the only
carry, the gates are tiny explicit state machines.
"""

import numpy as np


class ResetGate:
    """Tracks the environment reset counter (plus optional time jumps)
    and decides cold start vs. warm shift per tick."""

    def __init__(self, watch_time=False):
        self.watch_time = watch_time
        self.counter = 0
        self.pending = False
        self.prev_t = -1e4

    def poll(self, env):
        """Latch any reset since the last poll; returns the latch."""
        self.pending |= self.counter != env.reset_counter
        self.counter = env.reset_counter
        if self.watch_time:
            self.pending |= self.prev_t > env.t
            self.prev_t = env.t
        return self.pending

    def fire(self, env, shift=0, n=1):
        """Consume the latch. True = cold start required (reset seen, or
        the window shift fell outside the previous horizon)."""
        cold = self.poll(env) or not 0 <= shift < n
        self.pending = False
        return cold


class ArcShift:
    """Re-interpolates per-arc-length solver arrays after the path
    window advanced under the vehicle.

    The shift is measured by projecting the new window start onto the
    previous optimized path; every warm-start array is then resampled
    at (grid + shift) in one call.
    """

    def __init__(self):
        self.prev_path = None
        self.grid = np.zeros(1)
        self.query = np.zeros(1)

    def advance(self, path, step, horizon, project):
        self.grid = step * np.arange(horizon, dtype=float)
        if self.prev_path is None:
            self.query = self.grid.copy()
        else:
            travel = project(self.prev_path[:, :2], path[0, :2]).arc_len
            self.query = self.grid + travel
        self.prev_path = path

    def resample(self, arr, hold=False):
        """Linear (or zero-order-hold) re-interpolation along axis 0,
        extrapolating past the previous horizon."""
        arr = np.asarray(arr, dtype=float)
        x, q = self.grid, self.query
        if hold:
            idx = np.clip(np.searchsorted(x, q, side="right") - 1,
                          0, len(x) - 1)
            return arr[idx]
        if arr.ndim == 1:
            return _interp_extrap(q, x, arr)
        return np.stack([_interp_extrap(q, x, arr[:, j])
                         for j in range(arr.shape[1])], axis=1)


def _interp_extrap(q, x, y):
    """np.interp with linear extrapolation at both ends."""
    out = np.interp(q, x, y)
    if len(x) >= 2:
        lo = q < x[0]
        hi = q > x[-1]
        if lo.any():
            slope = (y[1] - y[0]) / (x[1] - x[0])
            out[lo] = y[0] + slope * (q[lo] - x[0])
        if hi.any():
            slope = (y[-1] - y[-2]) / (x[-1] - x[-2])
            out[hi] = y[-1] + slope * (q[hi] - x[-1])
    return out
