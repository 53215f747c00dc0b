from tpl_tpu_torch.planning.trajectory import Trajectory
from tpl_tpu_torch.planning.base_planner import BasePlanner
from tpl_tpu_torch.planning.path_vel_decomp import (
    PathSmoothing,
    PathOptim,
    VelocityOptim,
    PathVelDecompPlanner,
)
from tpl_tpu_torch.planning.dyn_prog import (
    DpEnv,
    DpEnvironment,
    DpLatLonPlanner,
    PolyLatDpLonPlanner,
    DpPolyPlanner,
    LatticePlanner,
)
from tpl_tpu_torch.planning.idm_sampling import IdmSamplingPlanner
from tpl_tpu_torch.planning.poly_sampling import PolySamplingPlanner
