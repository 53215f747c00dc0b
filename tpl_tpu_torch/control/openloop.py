"""
Open-loop helpers shared by the feedback controllers (flat,
feedforward): a timestamped command log with zero-order-hold replay,
and a closed-form kinematic-bicycle rollout.

The rollout exploits that the command sequence is known upfront: speed
and yaw are prefix sums, so the whole dead-time window integrates as
four cumsum expressions instead of a Python loop.

The port of tpl_tpu/control/openloop.py (numpy host code).
"""

import numpy as np


class StampedLog:
    """(t, acc, steer) command history for dead-time replay."""

    def __init__(self, capacity=500):
        self.capacity = capacity
        self.rows = []

    def clear(self):
        self.rows = []

    def push(self, t, acc, steer):
        self.rows.append((t, acc, steer))
        if len(self.rows) > self.capacity:
            self.rows.pop(0)

    def replay(self, t_from, t_to, step):
        """ZOH-sample the log on [t_from, t_to) at ``step``; returns
        (accs, steers) or None when the log is empty / window is."""
        if not self.rows:
            return None
        times = np.arange(t_from, t_to, step)
        if not len(times):
            return None
        hist = np.array(self.rows)
        idx = np.clip(np.searchsorted(hist[:, 0], times, side="right") - 1,
                      0, len(hist) - 1)
        return hist[idx, 1], hist[idx, 2]


def rollout_bicycle(state, accs, steers, wheel_base, dt, v_ch=None):
    """Integrate [x, y, yaw, delta, v] through a known command sequence.

    Per-step semantics match the serial model: pose advances with the
    pre-step speed/steering, then the commands latch. Closed form via
    prefix sums — no loop.
    """
    x, y, yaw, delta, v = state
    n = len(accs)
    if n == 0:
        return np.asarray(state, dtype=float).copy()

    v_seq = v + dt * np.concatenate([[0.0], np.cumsum(accs[:-1])])
    delta_seq = np.concatenate([[delta], steers[:-1]])
    wb = wheel_base if v_ch is None else \
        wheel_base * (1.0 + (v_seq / v_ch) ** 2)
    yaw_rate = v_seq * np.tan(delta_seq) / wb
    yaw_seq = yaw + dt * np.concatenate([[0.0], np.cumsum(yaw_rate[:-1])])

    return np.array([
        x + dt * np.sum(v_seq * np.cos(yaw_seq)),
        y + dt * np.sum(v_seq * np.sin(yaw_seq)),
        yaw + dt * np.sum(yaw_rate),
        steers[-1],
        v + dt * np.sum(accs)])


def compensate_dead_time(log, state, t, dead_time, step, wheel_base,
                         v_ch=None):
    """Forward-integrate ``state`` through the commands still in flight."""
    cmds = log.replay(t - dead_time, t, step)
    if cmds is None:
        return np.asarray(state, dtype=float).copy()
    accs, steers = cmds
    return rollout_bicycle(state, accs, steers, wheel_base, step, v_ch)


def lerp_extrap(tq, ts, ys):
    """np.interp with linear extrapolation on both ends."""
    ts = np.asarray(ts, dtype=float)
    ys = np.asarray(ys, dtype=float)
    out = np.interp(tq, ts, ys)
    if len(ts) >= 2:
        if tq < ts[0]:
            out = ys[0] + (ys[1] - ys[0]) / (ts[1] - ts[0]) * (tq - ts[0])
        elif tq > ts[-1]:
            out = ys[-1] + (ys[-1] - ys[-2]) / (ts[-1] - ts[-2]) \
                * (tq - ts[-1])
    return float(out)
