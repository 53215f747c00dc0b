"""
Per-component debug renderers, resolved through the store.

The reference GUI renders any shared store by looking up a
``__renderer__`` attribute published alongside the data (reference:
library/tpl/application/planning_app.py:42,
library/tpl/gui/state_and_params.py:32+), so every planner ships its own
view and the GUI needs no per-planner code.  This framework keeps that
contract in process-separated form: each component class declares a
``RENDERER`` import spec ("module:function"), the application registry
writes it into the component's store bundle as ``__renderer__``, and any
observer (scene renderer, HTTP GUI, offline recorder) resolves and calls
it with a snapshot of the bundle.  The functions draw onto a matplotlib
axes in world coordinates on top of the base scene.

Renderer signature: ``fn(ax, comp, local_map)`` where ``comp`` is the
snapshot of the component's shared bundle (``params``, ``debug``, ...).

The port of ``tpl_tpu/gui/renderers.py`` (host code; the imports renamed).
"""

import importlib

import numpy as np

from tpl_tpu_torch.ops.interp import lerp_xs


def resolve(spec):
    """Resolve a "module:function" renderer spec; None if unresolvable."""
    if not isinstance(spec, str) or ":" not in spec:
        return None
    mod_name, _, fn_name = spec.partition(":")
    try:
        return getattr(importlib.import_module(mod_name), fn_name, None)
    except ImportError:
        return None


def draw_component(ax, comp, local_map):
    """Dispatch to the component's published renderer, if any."""
    spec = getattr(comp, "__renderer__", None) if comp is not None else None
    fn = resolve(spec)
    if fn is None:
        return False
    try:
        fn(ax, comp, local_map)
    except Exception:
        # debug bundles are written concurrently and may be mid-shape;
        # a failed overlay must never take down the scene view
        return False
    return True


def _dbg(comp, *path):
    node = getattr(comp, "debug", None)
    for key in path:
        if node is None:
            return None
        node = getattr(node, key, None)
    return node


# -- RSTP (path/velocity decomposition) ---------------------------------

def rstp(ax, comp, local_map):
    """Corridor bounds, optimized path, and leader marker."""
    dbg = getattr(comp, "debug", None)
    if dbg is None or local_map is None or local_map.path is None:
        return
    d_lo = np.asarray(getattr(dbg, "d_lower_constr", np.zeros(0))).ravel()
    d_up = np.asarray(getattr(dbg, "d_upper_constr", np.zeros(0))).ravel()
    path = local_map.path
    if len(d_lo) >= 2 and len(d_up) >= 2:
        n = min(len(d_lo), len(d_up), len(path))
        p = path[:n]
        nx, ny = -np.sin(p[:, 2]), np.cos(p[:, 2])
        # d_upper_constr = -d_left + w/2, d_lower_constr = -d_right + w/2:
        # left edge at -d_upper along the left normal, right at +d_lower
        ax.plot(p[:, 0] - nx * d_up[:n], p[:, 1] - ny * d_up[:n],
                color="tab:green", lw=0.8, alpha=0.6, zorder=2)
        ax.plot(p[:, 0] + nx * d_lo[:n], p[:, 1] + ny * d_lo[:n],
                color="tab:green", lw=0.8, alpha=0.6, zorder=2,
                label="corridor")
    opt_path = getattr(dbg, "opt_path", None)
    if opt_path is None or len(np.atleast_2d(opt_path)) < 2:
        return
    op = np.atleast_2d(np.asarray(opt_path))
    ax.plot(op[:, 0], op[:, 1], "-", color="tab:olive", lw=1.2,
            alpha=0.9, zorder=3, label="opt path")
    # s_leader is ego-relative for moving leaders and path-relative for
    # stationary ones (velocity_optim.py select_leader quirk); the
    # optimized path is rebuilt from the ego projection each replan, so
    # the ego sits at arc ~0 and both frames coincide here to within the
    # warm-start drift
    s_leader = getattr(dbg, "s_leader", None)
    s_path = op[:, 3] - op[0, 3]
    if s_leader is not None and 0.0 < s_leader < s_path[-1]:
        lx = lerp_xs(np.array([s_leader]), s_path, op[:, 0])
        ly = lerp_xs(np.array([s_leader]), s_path, op[:, 1])
        ax.plot(lx, ly, "D", color="tab:red", ms=8, mec="k", zorder=6,
                label=f"leader v={getattr(dbg, 'v_leader', 0.0):.1f}")


# -- DP grid planners ----------------------------------------------------

def _grid_to_world(env_dbg, s_cells, l_cells):
    """(s, l) Frenet grid coordinates -> world xy via the published
    grid anchor line (x, y, phi rows at grid_s_step spacing)."""
    anchor = np.asarray(env_dbg.grid_anchor)
    step = float(env_dbg.grid_s_step)
    ss = np.arange(len(anchor)) * step
    x_r = lerp_xs(s_cells, ss, anchor[:, 0])
    y_r = lerp_xs(s_cells, ss, anchor[:, 1])
    h_r = lerp_xs(s_cells, ss, anchor[:, 2], angle=True)
    return (x_r - l_cells * np.sin(h_r), y_r + l_cells * np.cos(h_r))


def _draw_occ_overlay(ax, env_dbg, t_slice=0):
    occ = getattr(env_dbg, "occ_map", None) if env_dbg is not None else None
    if occ is None or getattr(env_dbg, "grid_anchor", None) is None:
        return
    occ = np.asarray(occ)
    l_min, l_step = float(env_dbg.grid_l_min), float(env_dbg.grid_l_step)
    # occ cells have their own s spacing (grid_s_cell), distinct from
    # the anchor rows' ref-line spacing used inside _grid_to_world
    s_min = float(getattr(env_dbg, "grid_s_min", 0.0))
    s_cell = float(getattr(env_dbg, "grid_s_cell", env_dbg.grid_s_step))
    si, li = np.nonzero(occ[t_slice] > 0.0)
    if len(si) == 0:
        return
    x, y = _grid_to_world(env_dbg, s_min + si * s_cell,
                          l_min + li * l_step)
    ax.plot(x, y, "s", color="tab:red", ms=2.5, alpha=0.35, zorder=2,
            label="occ grid")


def dp_lat_lon(ax, comp, local_map):
    """Occupancy-grid overlay + raw DP and smoothed trajectories."""
    _draw_occ_overlay(ax, _dbg(comp, "env"))
    env_dbg = _dbg(comp, "env")
    traj_dp = _dbg(comp, "planner", "traj_dp")
    if traj_dp is not None and env_dbg is not None \
            and getattr(env_dbg, "grid_anchor", None) is not None:
        tr = np.asarray(traj_dp)
        if len(tr) > 1:
            # cols: t, s, ds, dds, ddds, l, ... (lat_lon_kernel.py:24-26)
            x, y = _grid_to_world(env_dbg, tr[:, 1], tr[:, 5])
            ax.plot(x, y, "o--", color="tab:purple", ms=3, lw=0.9,
                    alpha=0.8, zorder=4, label="dp nodes")
    cart = _dbg(comp, "planner", "traj_smooth_cart")
    if cart is not None and len(np.atleast_2d(cart)) > 1:
        c = np.atleast_2d(np.asarray(cart))
        ax.plot(c[:, 2], c[:, 3], "-", color="tab:olive", lw=1.2,
                alpha=0.9, zorder=4, label="dp smooth")


def poly_lat_dp_lon(ax, comp, local_map):
    """Selected lateral polynomial path + occupancy overlay."""
    _draw_occ_overlay(ax, _dbg(comp, "env"))
    path = _dbg(comp, "planner", "path")
    if path is not None and len(np.atleast_2d(path)) > 1:
        p = np.atleast_2d(np.asarray(path))
        ax.plot(p[:, 0], p[:, 1], "-", color="tab:purple", lw=1.2,
                alpha=0.9, zorder=4, label="poly-lat path")


def dp_poly(ax, comp, local_map):
    """Winning behavior's node trajectory over the ref line."""
    dbg = getattr(comp, "debug", None)
    traj = getattr(dbg, "traj_dp", None) if dbg is not None else None
    rl = getattr(dbg, "ref_line", None) if dbg is not None else None
    if traj is None or rl is None:
        return
    tr, rl = np.asarray(traj), np.asarray(rl)
    if len(tr) < 2 or len(rl) < 2:
        return
    # node cols: t, s, ds, dds, l, ... (dp_poly_planner.py:28); ref line
    # cols 0..5 = x, y, phi, s, k, v
    x_r = lerp_xs(tr[:, 1], rl[:, 3] - rl[0, 3], rl[:, 0])
    y_r = lerp_xs(tr[:, 1], rl[:, 3] - rl[0, 3], rl[:, 1])
    h_r = lerp_xs(tr[:, 1], rl[:, 3] - rl[0, 3], rl[:, 2], angle=True)
    ax.plot(x_r - tr[:, 4] * np.sin(h_r), y_r + tr[:, 4] * np.cos(h_r),
            "o--", color="tab:purple", ms=3, lw=0.9, alpha=0.8, zorder=4,
            label="dp nodes")


# -- sampling planners ---------------------------------------------------

def idm_sampling(ax, comp, local_map):
    """Candidate rollout fan, colored valid/invalid, winner highlighted."""
    dbg = getattr(comp, "debug", None)
    cand = getattr(dbg, "cand_xy", None) if dbg is not None else None
    if cand is None:
        return
    cand = np.asarray(cand)
    invalid = np.asarray(getattr(dbg, "cand_invalid",
                                 np.zeros(len(cand)))).astype(bool)
    i_sel = int(getattr(dbg, "i_select", -1))
    for i, c in enumerate(cand):
        if i == i_sel:
            continue
        ax.plot(c[:, 0], c[:, 1], "-",
                color="tab:red" if invalid[i] else "0.6",
                lw=0.7, alpha=0.5, zorder=3)
    if 0 <= i_sel < len(cand):
        ax.plot(cand[i_sel, :, 0], cand[i_sel, :, 1], "-",
                color="tab:purple", lw=1.4, alpha=0.9, zorder=4,
                label="selected rollout")


def poly_sampling(ax, comp, local_map):
    """Winning Frenet-poly candidate + its sampling grid metadata."""
    dbg = getattr(comp, "debug", None)
    if dbg is None:
        return
    x = np.asarray(getattr(dbg, "x", np.zeros(0))).ravel()
    y = np.asarray(getattr(dbg, "y", np.zeros(0))).ravel()
    if len(x) > 1:
        ax.plot(x, y, "o-", color="tab:purple", ms=2.5, lw=1.0,
                alpha=0.85, zorder=4,
                label=f"poly cand (cost {getattr(dbg, 'cost', 0.0):.1f})")
