"""
Map editor: live editing operations over the environment's map store.

The reference ships an imviz map editor view (reference:
library/tpl/gui/views/map_editor.py — interactive control-point editing,
road widths, velocities, map items, map creation, store persistence).
This module provides the same capabilities as a set of store-level edit
operations — usable programmatically, from tests, and from the tplgui
HTTP surface (``/editor`` page, ``/map.json``, ``POST /map/edit``,
``POST /map/save``).

Edits mutate the shared environment store under its lock, recompute the
map discretization (reinit_map) and bump ``env.reset_counter`` so all
planners drop their warm starts — matching how the reference invalidates
state when the world changes (reference: env_state.py:17-30).

The port of ``tpl_tpu/gui/map_editor.py`` (host code; the imports renamed).
"""

import os

import numpy as np

from tpl_tpu_torch import util
from tpl_tpu_torch.environment.map_module import (
    Map, VelocityLimit, TrafficLight, CrossWalk, TurnIndPoint,
    MapSwitchPoint, IntersectionPath, reinit_map, reinit_map_items,
    _ITEM_CLASSES,
)


_CP_FIELDS = {"x": 0, "y": 1, "d_left": 2, "d_right": 3, "v": 4, "alt": 5}
_MAP_FIELDS = ("name", "smoothing", "step_size_discr", "closed_path")


class MapEditor:
    """Edit operations over ``env.maps``; all methods lock the env."""

    UNDO_DEPTH = 50

    def __init__(self, env):
        self.env = env
        # undo stack of (map_key_or_None, deep snapshot); None key means
        # a store-level op (new/delete map) snapshotting the whole store
        self._undo = []

    # -- queries ----------------------------------------------------

    def list_maps(self):
        self.env.revalidate()
        with self.env.lock():
            return {k: m.name for k, m in
                    util.get_obj_dict(self.env.maps).items()}

    def map_dict(self, key):
        """Full map view for rendering: control points, discretized
        path, boundaries, items."""
        self.env.revalidate()
        with self.env.lock():
            m = util.get_obj_dict(self.env.maps).get(key)
            if m is None:
                raise KeyError(f"no map {key!r}")
            items = []
            for lst, kind in (
                    (m.velocity_limits, None),
                    (m.turn_ind_points, "turn_ind_point"),
                    (m.map_switch_points, "map_switch_point"),
                    (m.intersection_paths, "intersection_path")):
                for it in lst:
                    d = {"kind": getattr(it, "__tag__", kind),
                         "uuid": it.uuid,
                         "pos": np.asarray(it.pos).tolist()}
                    for f in ("limit", "length", "dir", "target_uuid",
                              "intersection_map_uuid", "free_limit",
                              "d_decision", "detection_radius"):
                        if hasattr(it, f):
                            d[f] = _plain(getattr(it, f))
                    items.append(d)
            return {
                "key": key,
                "name": m.name,
                "uuid": m.uuid,
                "closed_path": bool(m.closed_path),
                "smoothing": float(m.smoothing),
                "step_size_discr": float(m.step_size_discr),
                "control_points": np.asarray(m.control_points).tolist(),
                "path": (np.asarray(m.path).tolist()
                         if m.path is not None else []),
                "boundary_left": (np.asarray(m.boundary_left).tolist()
                                  if m.boundary_left is not None else []),
                "boundary_right": (np.asarray(m.boundary_right).tolist()
                                   if m.boundary_right is not None else []),
                "items": items,
            }

    # -- edit dispatch ----------------------------------------------

    def edit(self, req):
        """Apply one edit operation (dict with an ``op`` field)."""
        op = req["op"]
        if op == "undo":
            return self.undo()
        fn = getattr(self, "op_" + op, None)
        if fn is None:
            raise ValueError(f"unknown edit op {op!r}")
        self.env.revalidate()
        with self.env.lock():
            maps = util.get_obj_dict(self.env.maps)
            if op not in ("new_map", "delete_map"):
                m = maps.get(req.get("map"))
                if m is None:
                    raise KeyError(f"no map {req.get('map')!r}")
                self._push_undo(req.get("map"), util.snapshot(m))
                try:
                    fn(m, req, maps)
                    reinit_map(m)
                    reinit_map_items(m, self.env.maps)
                except Exception:
                    # roll the partial edit back and drop the junk
                    # undo entry, so a failed op is a no-op
                    key, snap = self._undo.pop()
                    setattr(self.env.maps, key, snap)
                    raise
            else:
                self._push_undo(None, util.snapshot(self.env.maps))
                try:
                    fn(None, req, maps)
                except Exception:
                    _, snap = self._undo.pop()
                    self.env.maps = snap
                    raise
            self.env.reset_counter += 1
            self.env.maps = self.env.maps   # republish through the store

    def _push_undo(self, key, snap):
        self._undo.append((key, snap))
        del self._undo[:-self.UNDO_DEPTH]

    def undo(self):
        """Restore the state before the most recent edit."""
        if not self._undo:
            raise ValueError("nothing to undo")
        key, snap = self._undo.pop()
        self.env.revalidate()
        with self.env.lock():
            if key is None:
                self.env.maps = snap
            else:
                setattr(self.env.maps, key, snap)
                reinit_map_items(snap, self.env.maps)
            self.env.reset_counter += 1
            self.env.maps = self.env.maps

    # control points

    def op_move_cp(self, m, req, maps):
        i = int(req["index"])
        m.control_points[i, 0] = float(req["x"])
        m.control_points[i, 1] = float(req["y"])

    def op_insert_cp(self, m, req, maps):
        """Insert after ``index`` (or append with index = -1)."""
        cps = np.asarray(m.control_points)
        i = int(req.get("index", len(cps) - 1))
        if len(cps) == 0:
            row = np.array([float(req["x"]), float(req["y"]),
                            2.0, 2.0, 10.0, 0.0])
            m.control_points = row[None]
            return
        i = max(0, min(i, len(cps) - 1))
        row = cps[i].copy()
        row[0], row[1] = float(req["x"]), float(req["y"])
        m.control_points = np.insert(cps, i + 1, row, axis=0)

    def op_delete_cp(self, m, req, maps):
        i = int(req["index"])
        m.control_points = np.delete(
            np.asarray(m.control_points), i, axis=0)

    def op_set_cp_field(self, m, req, maps):
        """Set one column (d_left/d_right/v/alt/x/y) over an index range."""
        col = _CP_FIELDS[req["field"]]
        i0 = int(req.get("start", 0))
        i1 = int(req.get("end", len(m.control_points) - 1))
        m.control_points[i0:i1 + 1, col] = float(req["value"])

    def op_drag_boundary(self, m, req, maps):
        """Drag a road boundary: reshape the width column (d_left or
        d_right) so the boundary passes through the dragged position.
        The width change lands on the control point nearest to the grab
        location (the reference editor's boundary handles work per
        control point, gui/views/map_editor.py)."""
        side = req["side"]
        if side not in ("left", "right"):
            raise KeyError(f"side must be left/right, got {side!r}")
        pos = np.array([float(req["x"]), float(req["y"])])
        if m.path is None or len(m.path) < 2:
            raise ValueError("map has no discretized path")
        proj = util.project(m.path[:, :2], pos)
        width = proj.distance if side == "left" else -proj.distance
        cps = np.asarray(m.control_points)
        i = int(np.argmin(np.linalg.norm(cps[:, :2] - proj.point, axis=1)))
        cps[i, 2 if side == "left" else 3] = max(0.1, float(width))

    # map-level fields

    def op_set_map_field(self, m, req, maps):
        field = req["field"]
        if field not in _MAP_FIELDS:
            raise KeyError(f"not an editable map field: {field!r}")
        value = req["value"]
        if field == "closed_path":
            value = bool(value)
        elif field != "name":
            value = float(value)
        setattr(m, field, value)

    # items

    def op_add_item(self, m, req, maps):
        kind = req["kind"]
        cls = _ITEM_CLASSES.get(kind)
        if cls is None:
            raise KeyError(f"unknown item kind {kind!r}")
        item = cls()
        item.pos = np.array([float(req["x"]), float(req["y"])])
        if kind == "traffic_light":
            item.light_pos = item.pos.copy()
        elif kind == "cross_walk":
            item.corners = item.pos[None] + np.array(
                [[-2.0, -4.0], [2.0, -4.0], [2.0, 4.0], [-2.0, 4.0]])
        elif kind == "intersection_path":
            item.stop_pos = item.pos + np.array([2.0, 2.0])
        if kind in ("velocity_limit", "traffic_light", "cross_walk"):
            m.velocity_limits.append(item)
        elif kind == "turn_ind_point":
            m.turn_ind_points.append(item)
        elif kind == "map_switch_point":
            m.map_switch_points.append(item)
        else:
            m.intersection_paths.append(item)

    def _find_item(self, m, uid):
        for lst in (m.velocity_limits, m.turn_ind_points,
                    m.map_switch_points, m.intersection_paths):
            for it in lst:
                if it.uuid == uid:
                    return lst, it
        raise KeyError(f"no item {uid!r}")

    def op_delete_item(self, m, req, maps):
        lst, it = self._find_item(m, req["uuid"])
        lst.remove(it)

    def op_move_item(self, m, req, maps):
        """Translate an item on the canvas; linked geometry (light
        position, crosswalk corners, stop position) moves with it."""
        _, it = self._find_item(m, req["uuid"])
        new_pos = np.array([float(req["x"]), float(req["y"])])
        delta = new_pos - np.asarray(it.pos, dtype=np.float64)
        it.pos = new_pos
        for f in ("light_pos", "stop_pos"):
            if hasattr(it, f):
                setattr(it, f, np.asarray(getattr(it, f)) + delta)
        if hasattr(it, "corners") and np.asarray(it.corners).size:
            it.corners = (np.asarray(it.corners, dtype=np.float64)
                          .reshape(-1, 2) + delta)

    def op_set_item_field(self, m, req, maps):
        _, it = self._find_item(m, req["uuid"])
        field = req["field"]
        if field.startswith("_") or not hasattr(it, field):
            raise KeyError(f"item has no field {field!r}")
        cur = getattr(it, field)
        value = req["value"]
        if isinstance(cur, np.ndarray):
            value = np.asarray(value, dtype=np.float64)
        elif isinstance(cur, bool):
            value = bool(value)
        elif isinstance(cur, (int, np.integer)):
            value = int(value)
        elif isinstance(cur, float):
            value = float(value)
        setattr(it, field, value)

    # maps

    def op_new_map(self, _m, req, maps):
        key = req["key"]
        if key in maps:
            raise KeyError(f"map {key!r} already exists")
        m = Map(req.get("name", key))
        x0 = float(req.get("x", 0.0))
        y0 = float(req.get("y", 0.0))
        cps = np.zeros((2, 6))
        cps[:, 0] = (x0, x0 + 20.0)
        cps[:, 1] = (y0, y0)
        cps[:, 2:4] = 3.0
        cps[:, 4] = 10.0
        m.control_points = cps
        reinit_map(m)
        setattr(self.env.maps, key, m)

    def op_delete_map(self, _m, req, maps):
        key = req["key"]
        if key not in maps:
            raise KeyError(f"no map {key!r}")
        delattr(self.env.maps, key)

    # -- persistence ------------------------------------------------

    def save(self, store_path=None):
        """Persist the current map store (objtoolbox-compatible)."""
        self.env.revalidate()
        with self.env.lock():
            path = store_path or self.env.map_store_path
            if not path:
                raise ValueError("no map_store_path set")
            out = os.path.join(util.PATH_MAPS, path)
            util.save_state_dict(self.env.maps, out)
            self.env.map_store_path = path
            return out


def _plain(v):
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, (np.floating, np.integer)):
        return v.item()
    return v
