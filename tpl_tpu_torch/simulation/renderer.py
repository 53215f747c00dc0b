"""
Headless scene renderer: the framework's observability surface.

Replaces the reference's imviz/imdash GUI components (reference:
library/tpl/gui/components/{vehicle,trajectory,dynamic_objects,
map_objects,map_paths,traffic_lights}.py, library/tpl/simulation/
renderer.py) with matplotlib renderings of the shared stores: map
boundaries and items, ego vehicle, tracked dynamic objects with
predictions and history trails, planned trajectory, planner debug data
(corridors, occupancy / distance grids).  The view follows the ego
(follow-cam).  The CARLA birdseye component has no counterpart here
(no CARLA bridge in this build).

The port of ``tpl_tpu/simulation/renderer.py`` (host code; the imports
renamed).
"""

import os

import numpy as np

import matplotlib
matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

from tpl_tpu_torch.simulation.state import SimCar, SimEgo


def _draw_map(ax, local_map):
    if local_map is None or local_map.path is None:
        return
    ax.plot(local_map.path[:, 0], local_map.path[:, 1],
            "--", color="0.6", lw=0.8, label="ref line")
    if local_map.boundary_left is not None:
        ax.plot(local_map.boundary_left[:, 0],
                local_map.boundary_left[:, 1], "k-", lw=1.0)
    if local_map.boundary_right is not None:
        ax.plot(local_map.boundary_right[:, 0],
                local_map.boundary_right[:, 1], "k-", lw=1.0)


_TL_COLORS = {0: "red", 1: "gold", 2: "limegreen", 3: "0.4"}


def _draw_map_items(ax, local_map):
    """Map items like the reference's MapObjects component: velocity
    limits, traffic lights (colored by state), crosswalks, turn
    indicator points, map switch points, intersection path segments."""
    if local_map is None:
        return
    for vl in getattr(local_map, "velocity_limits", []):
        tag = getattr(vl, "__tag__", "velocity_limit")
        pos = np.asarray(vl.pos)
        if tag == "traffic_light":
            c = _TL_COLORS.get(int(getattr(vl, "state", 3)), "0.4")
            ax.plot(*pos, "o", color=c, ms=9, mec="k", zorder=6)
        elif tag == "cross_walk":
            corners = np.asarray(getattr(vl, "corners", np.zeros(0)))
            if corners.size >= 6:
                ax.fill(corners.reshape(-1, 2)[:, 0],
                        corners.reshape(-1, 2)[:, 1],
                        color="tab:purple", alpha=0.25, zorder=2)
            ax.plot(*pos, "s", color="tab:purple", ms=6, zorder=6)
        else:
            ax.plot(*pos, "v", color="tab:red", ms=7, zorder=6)
            ax.annotate(f"{getattr(vl, 'limit', 0.0):.0f}",
                        pos, fontsize=7, ha="center",
                        xytext=(0, 6), textcoords="offset points")
    for tp in getattr(local_map, "turn_ind_points", []):
        ax.plot(*np.asarray(tp.pos), "1", color="tab:cyan", ms=8, zorder=6)
    for mp in getattr(local_map, "map_switch_points", []):
        ax.plot(*np.asarray(mp.pos), "P", color="tab:brown", ms=6, zorder=6)
    for ip in getattr(local_map, "intersection_paths", []):
        seg = getattr(ip, "map_segment", None)
        if seg is not None and getattr(seg, "path", None) is not None:
            ax.plot(seg.path[:, 0], seg.path[:, 1], "-",
                    color="tab:olive", lw=1.0, alpha=0.8, zorder=2)
        ax.plot(*np.asarray(ip.stop_pos), "x", color="tab:olive",
                ms=7, zorder=6)


def _draw_tracked_objects(ax, objects):
    """Tracked/predicted objects like the reference's DynamicObjects
    component: hull footprint, velocity arrow, prediction polylines."""
    labeled = False
    for obj in objects or []:
        hull = np.asarray(getattr(obj, "hull", np.zeros((0, 2))))
        pos = np.asarray(obj.pos)
        if len(hull) >= 3:
            ax.fill(hull[:, 0], hull[:, 1], color="tab:red", alpha=0.45,
                    zorder=4, label=None if labeled else "tracked")
            labeled = True
        v = float(getattr(obj, "v", 0.0) or 0.0)
        yaw = getattr(obj, "yaw", None)
        if yaw is not None and v > 0.3:
            ax.arrow(pos[0], pos[1], v * np.cos(yaw), v * np.sin(yaw),
                     head_width=0.6, color="tab:red", alpha=0.8, zorder=5)
        for pred in getattr(obj, "predictions", []) or []:
            st = np.asarray(pred.states)
            if len(st) > 1:
                ax.plot(st[:, 1], st[:, 2], ":", color="tab:red",
                        lw=1.0, alpha=0.7, zorder=3)


class SceneRenderer:
    """Stateful renderer keeping per-object history trails across frames
    (the reference DynamicObjects component's history feature)."""

    def __init__(self, history_len=100, tiles=True):
        from tpl_tpu_torch.gui.map_tiles import TileLayer
        self.tile_layer = TileLayer() if tiles else None
        self.history_len = history_len
        self.ego_history = []
        self.obj_history = {}

    def _update_history(self, sim, objects):
        self.ego_history.append((sim.ego.x, sim.ego.y))
        self.ego_history = self.ego_history[-self.history_len:]
        seen = set()
        for obj in objects or []:
            key = getattr(obj, "uuid", None) or id(obj)
            seen.add(key)
            h = self.obj_history.setdefault(key, [])
            h.append(tuple(np.asarray(obj.pos)))
            del h[:-self.history_len]
        for key in list(self.obj_history):
            if key not in seen:
                del self.obj_history[key]

    def render(self, env, sim, planners=None, ax=None, window=120.0):
        with env.lock():
            local_map = env.local_map
            objects = list(env.predicted)
        self._update_history(sim, objects)
        return render_scene(
            env, sim, planners=planners, ax=ax, window=window,
            local_map=local_map, objects=objects,
            ego_history=self.ego_history,
            obj_history=list(self.obj_history.values()),
            tile_layer=self.tile_layer)

    __call__ = render


def render_scene(env, sim, planners=None, ax=None, window=120.0,
                 local_map=None, objects=None,
                 ego_history=None, obj_history=None, tile_layer=None):
    """Render the current scene around the ego; returns an RGB array."""
    own_fig = ax is None
    if own_fig:
        fig, ax = plt.subplots(figsize=(8, 8), dpi=80)
    else:
        fig = ax.figure

    if local_map is None or objects is None:
        with env.lock():
            local_map = env.local_map
            objects = list(env.predicted)

    if tile_layer is not None:
        # background imagery/grid behind everything (reference slot:
        # gui/components/map_tiles_component.py)
        tile_layer.draw(ax, sim.ego.x - window / 2, sim.ego.x + window / 2,
                        sim.ego.y - window / 2, sim.ego.y + window / 2)

    _draw_map(ax, local_map)
    _draw_map_items(ax, local_map)

    # history trails
    for h in obj_history or []:
        if len(h) > 1:
            harr = np.asarray(h)
            ax.plot(harr[:, 0], harr[:, 1], "-", color="tab:red",
                    lw=0.6, alpha=0.35, zorder=1)
    if ego_history and len(ego_history) > 1:
        eh = np.asarray(ego_history)
        ax.plot(eh[:, 0], eh[:, 1], "-", color="tab:blue",
                lw=0.6, alpha=0.4, zorder=1)

    # simulation ground truth traffic
    for sc in sim.cars:
        hull = SimCar.get_convex_hull(sc)
        ax.fill(hull[:, 0], hull[:, 1], color="tab:orange", alpha=0.5,
                zorder=3)

    _draw_tracked_objects(ax, objects)

    # ego
    hull = SimEgo.get_convex_hull(sim.ego)
    ax.fill(hull[:, 0], hull[:, 1], color="tab:blue", alpha=0.9,
            zorder=5, label="ego")

    # planned trajectory + the active planner's own debug view,
    # resolved through the store's __renderer__ hook
    if planners is not None:
        from tpl_tpu_torch.gui.renderers import draw_component
        from tpl_tpu_torch.util import Bundle, snapshot
        with planners.lock():
            traj = getattr(planners, "trajectory", None)
            active = getattr(planners, "active_planner", "")
            comp = getattr(planners, active, None)
            # snapshot only what the debug views read — copying params
            # and warm-start state under the planner's lock every frame
            # would stall the publisher
            if comp is not None:
                comp = Bundle(
                    __renderer__=getattr(comp, "__renderer__", None),
                    debug=snapshot(getattr(comp, "debug", None)))
        if traj is not None and len(np.atleast_1d(traj.x)) > 1:
            emergency = bool(getattr(traj, "emergency", False))
            ax.plot(traj.x, traj.y, "-",
                    color="crimson" if emergency else "g", lw=2.0,
                    zorder=4, label="plan (EMERGENCY)" if emergency
                    else "plan")
        draw_component(ax, comp, local_map)

    ax.set_xlim(sim.ego.x - window / 2, sim.ego.x + window / 2)
    ax.set_ylim(sim.ego.y - window / 2, sim.ego.y + window / 2)
    ax.set_aspect("equal")
    ax.legend(loc="upper right", fontsize=8)
    ax.set_title(f"t = {sim.t:.2f} s   v = {sim.ego.v:.1f} m/s")

    if own_fig:
        fig.canvas.draw()
        buf = np.asarray(fig.canvas.buffer_rgba())[:, :, :3].copy()
        plt.close(fig)
        return buf
    return None


def render_occ_map(occ_map, path=None, t_slice=0):
    """Render one time slice of the (t, s, l) occupancy grid."""
    fig, ax = plt.subplots(figsize=(10, 3), dpi=80)
    ax.imshow(np.asarray(occ_map)[t_slice].T, origin="lower",
              aspect="auto", cmap="viridis", interpolation="nearest")
    ax.set_xlabel("s index")
    ax.set_ylabel("l index")
    ax.set_title(f"occupancy, t slice {t_slice}")
    if path is not None:
        fig.savefig(path, bbox_inches="tight")
        plt.close(fig)
        return path
    fig.canvas.draw()
    buf = np.asarray(fig.canvas.buffer_rgba())[:, :, :3].copy()
    plt.close(fig)
    return buf


def save_frames(frames, out_dir):
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i, frame in enumerate(frames):
        p = os.path.join(out_dir, f"frame_{i:05d}.png")
        plt.imsave(p, frame)
        paths.append(p)
    return paths
