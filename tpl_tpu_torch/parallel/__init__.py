"""Scale-out: scenario batches and candidate fans sharded over a mesh of
devices (the port of ``tpl_tpu/parallel``), and the sharded step suite
``dryrun_multichip``."""

from tpl_tpu_torch.parallel.mesh import (
    scenario_mesh,
    shard_scenarios,
    sharded_best_candidate,
    init_distributed,
)
from tpl_tpu_torch.parallel.kernels import (
    sharded_idm_sweep,
    sharded_latlon_batch,
    sharded_env_build,
)
from tpl_tpu_torch.parallel.dryrun import dryrun_multichip, mpc_setup
