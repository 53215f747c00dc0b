from tpl_tpu_torch.planning.poly_sampling.poly_sampling_planner import (
    PolySamplingPlanner,
)
