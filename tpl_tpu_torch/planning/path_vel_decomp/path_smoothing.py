"""
RSTP smooth-only stage: fit a curvature-controlled unicycle to the raw
reference line, yielding a smoothed local path without corridor logic.
Its problem, ``ref_line_smoother_k``, is solved on a CUDA device by the
generic AL-iLQR kernel (``csrc/ilqr_generic.cu``, one launch a replan at
the horizon of 250, float32), on the CPU by the plain torch iLQR.

Behavioral parity target:
library/tpl/planning/path_vel_decomp/path_smoothing.py:36-83.
"""

import numpy as np

from tpl_tpu_torch.util import runtime
from tpl_tpu_torch.optim import problems
from tpl_tpu_torch.optim.solver import Solver
from tpl_tpu_torch.planning.path_vel_decomp.warm_start import ResetGate


class Params:

    def __init__(self):
        self.horizon = 250
        self.step = 0.5
        self.ref_step = 0.5
        self.k_min = -1.0
        self.k_max = 1.0
        self.w_pos = 1.0
        self.w_k = 0.1


class PathSmoothing:
    """Tracks the reference polyline with states (x, y, phi) and the
    curvature as the single control; the solve is a smoothing spline in
    disguise, warm-shifted as the window slides."""

    def __init__(self, horizon_max=250):
        prob, spec = problems.ref_line_smoother_k(ref_capacity=512)
        self.opt = Solver(prob, spec, horizon_max=horizon_max)
        self.opt.lg_mult_limit = 0.1
        self.opt.barrier_weight[:] = 1000.0
        self.gate = ResetGate()
        self.opt_path = np.zeros((1, 6))

    # planner-facing reset hook (mirrors PathOptim's)
    @property
    def reset_required(self):
        return self.gate.pending

    @reset_required.setter
    def reset_required(self, flag):
        self.gate.pending = bool(flag)

    @runtime
    def update(self, env, params):
        window = env.local_map
        n = min(params.horizon, window.steps_ref)
        ref = window.path[:n]

        opt = self.opt
        opt.integrator_type = opt.EULER
        opt.horizon = n
        opt.step = params.step
        opt.u_min[:] = params.k_min
        opt.u_max[:] = params.k_max
        opt.params.merge(dict(
            w_pos=params.w_pos, w_k=params.w_k,
            ref_x=ref[:, 0], ref_y=ref[:, 1],
            ref_step=window.step_size_ref))

        slid = window.shift_idx_start_ref
        if self.gate.fire(env, shift=slid, n=n):
            # cold start: seed pose and curvature from the raw line
            opt.x[0, :] = ref[0, :3]
            opt.u = ref[:n, 4]
        else:
            opt.shift(slid)

        opt.update()

        # smoothed pose from the states, curvature from the control,
        # arc-length/velocity channels passed through from the window
        out = np.zeros((n, 6))
        out[:, :3] = opt.x[:-1, :3]
        out[:, 4] = opt.u[:, 0]
        out[:, 3] = ref[:, 3]
        out[:, 5] = ref[:, 5]
        self.opt_path = out
