from tpl_tpu_torch.optim.ilqr import (
    EULER, HEUN, RK4,
    Problem,
    SolverState,
    make_update_fn,
    init_state,
)
from tpl_tpu_torch.optim.solver import Solver, ArraySpec
from tpl_tpu_torch.optim import problems
from tpl_tpu_torch.optim.problems import (
    lateral_profile,
    velocity_profile_space,
    velocity_profile_time,
    ref_line_smoother_k,
    ref_line_smoother_dk,
    trajectory_tracking_mpc,
    trajectory_tracking_mpc_time,
)

# genopt-compatible sympy frontend + ready-made solver-class module
# (import as modules to avoid shadowing the problem factories above:
#  `from tpl_tpu_torch.optim import genopt, optimizers`)
from tpl_tpu_torch.optim import symext
