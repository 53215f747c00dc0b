from tpl_tpu_torch.ops.interp import (
    normalize_angle,
    short_angle_dist,
    lerp_xs,
    lerp,
    lerp_angle,
    box_interp,
    blerp,
)
from tpl_tpu_torch.ops.geometry import (
    Projection,
    project,
    project_many,
    resample,
    interp_resampled_path,
    resample_path,
    path_segment,
    build_route,
    convex_hull,
    point_in_polygon,
    intersect_polygons,
    intersect_polygons_batch,
)
from tpl_tpu_torch.ops.profile import (
    rampify_profile,
    curv_to_vel_profile,
    zero_after_first_zero,
    add_vel_constraint,
)
from tpl_tpu_torch.ops.splines import (
    PolyCubic,
    PolyQuintic,
    PolySeptic,
    PolyQuartic,
)
from tpl_tpu_torch.ops.lqr import (
    lqr_smoother,
    lqr_smoother_torch,
    smooth_path_positions,
)

# reference-surface aliases (tplcpp.smooth_path, utils.cpp:694;
# tplcpp.gen_prediction_geometry, utils.cpp:576: the quad form replaces the
# GL triangle list, dp_environment.gen_prediction_quads)
smooth_path = smooth_path_positions


def gen_prediction_geometry(pred_states, hull, path, ts,
                            station_step_size=5.0, sweep_length=0.5):
    """The swept prediction footprint of an object as (quad, t) pairs
    (``planning.dyn_prog.dp_environment.gen_prediction_quads``)."""
    from tpl_tpu_torch.planning.dyn_prog.dp_environment import (
        gen_prediction_quads)
    return gen_prediction_quads(pred_states, hull, path, ts,
                                station_step_size=station_step_size,
                                sweep_length=sweep_length)
