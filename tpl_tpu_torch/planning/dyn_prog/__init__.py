from tpl_tpu_torch.planning.dyn_prog.dp_environment import (
    DpEnvGrid,
    DpEnvParams,
    DpEnvironment,
)
from tpl_tpu_torch.planning.dyn_prog.dp_env import DpEnv
from tpl_tpu_torch.planning.dyn_prog.dp_lat_lon_planner import DpLatLonPlanner
from tpl_tpu_torch.planning.dyn_prog.poly_lat_dp_lon_planner import (
    PolyLatDpLonPlanner,
)
from tpl_tpu_torch.planning.dyn_prog.dp_poly_planner import DpPolyPlanner
from tpl_tpu_torch.planning.dyn_prog.lattice_planner import LatticePlanner
