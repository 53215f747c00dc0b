from tpl_tpu_torch.planning.path_vel_decomp.path_smoothing import (
    PathSmoothing,
)
from tpl_tpu_torch.planning.path_vel_decomp.path_optim import PathOptim
from tpl_tpu_torch.planning.path_vel_decomp.velocity_optim import (
    VelocityOptim,
)
from tpl_tpu_torch.planning.path_vel_decomp.path_vel_decomp_planner import (
    PathVelDecompPlanner,
)
