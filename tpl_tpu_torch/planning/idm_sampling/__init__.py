from tpl_tpu_torch.planning.idm_sampling.idm_sampling_planner import (
    IdmSamplingPlanner,
)
