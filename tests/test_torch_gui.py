"""The port's GUI (``tpl_tpu_torch.gui``): the cases of tests/test_gui.py
on the port, then two of its own.

- The JAX package's cases, on the port's ``SimStandalone`` on the
  ``default`` scenario (the demo param sets): the live state and scene, the
  birdseye panel, selecting and editing params, the map editor, the param
  set selector (loading ``demo`` where the JAX case names the absent
  ``default`` set), the planners' renderer hooks (every planner publishes
  ``tpl_tpu_torch.gui.renderers:*``), the event log, the tile layer and the
  crane example's interactive view (``tpl_tpu_torch.examples.crane_2d``).
- ``/state.json`` after TICKS ticks of each package's ``SimStandalone`` on
  ``demo/country_follow``, cut as in tests/test_torch_demo_loops.py, has
  the JAX GUI's keys; t, the names, the flags and the violations equal,
  the ego and the controls within its ATOL.  The runtimes are host clock
  readings and are compared as types only.

The GUI attached by app id to a running multi-process loop is tested with
that loop, in tests/test_torch_multiprocess.py.
"""

import json
import os
import urllib.request
import uuid

import numpy as np
import pytest

import tpl_tpu_torch
from tpl_tpu_torch import util


@pytest.fixture
def sim_and_gui():
    tpl_tpu_torch.use_device("cpu")
    util.StoreRegistry.clear()
    from tpl_tpu_torch.simulation import SimStandalone
    from tpl_tpu_torch.gui import GuiServer

    sim = SimStandalone(app_id="guitest", scenario_path="default")
    with sim.core.sh_state.lock():
        ss = sim.core.sh_state.sim
        ss.settings.running = True
        ss.settings.use_real_time = False

    gui = GuiServer(
        port=0,
        env=sim.env_app.env,
        sim_store=sim.core.sh_state,
        planning_store=sim.planning_app.sh_planners,
        control_store=sim.control_app.sh_controllers).start()
    yield sim, gui
    gui.stop()
    util.StoreRegistry.clear()


def _get(gui, path):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{gui.port}{path}", timeout=30) as r:
        return r.status, r.read()


def _post(gui, path, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{gui.port}{path}",
        data=json.dumps(payload).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.status


def test_state_and_scene(sim_and_gui):
    sim, gui = sim_and_gui
    for _ in range(5):
        sim.update()

    status, body = _get(gui, "/state.json")
    assert status == 200
    state = json.loads(body)
    assert state["t"] > 0.0
    assert state["planning"]["active"] in state["planning"]["names"]
    assert state["control"]["active"] in state["control"]["names"]
    assert isinstance(state["violations"], list)

    status, body = _get(gui, "/")
    assert status == 200 and b"tpl-tpu" in body

    status, png = _get(gui, "/scene.png")
    assert status == 200
    assert png[:8] == b"\x89PNG\r\n\x1a\n"


def test_birdseye_panel(sim_and_gui):
    """Bird's-eye camera panel (reference slot:
    gui/components/carla_birdseye_component.py): the synthetic top-down
    source serves frames through the GUI; an external cam_info source
    (the CARLA-bridge contract) takes over when installed; the CARLA
    bridge itself gates cleanly on the missing client package."""
    import math
    import numpy as np
    from tpl_tpu_torch.gui.birdseye import BirdseyeView, CamInfo, view_extent

    sim, gui = sim_and_gui
    for _ in range(3):
        sim.update()

    status, png = _get(gui, "/birdseye.png")
    assert status == 200
    assert png[:8] == b"\x89PNG\r\n\x1a\n"

    # camera extent mapping == the reference's
    # (carla_birdseye_component.py:33: tan(fov/2) * altitude * 2)
    x0, x1, y0, y1 = view_extent((10.0, -4.0, 50.0), 90.0)
    size = math.tan(math.radians(45.0)) * 50.0 * 2.0
    assert x1 - x0 == pytest.approx(size)
    assert (x0 + x1) / 2 == pytest.approx(10.0)
    assert (y0 + y1) / 2 == pytest.approx(-4.0)

    # an installed external source wins over the synthetic renderer
    view = BirdseyeView()
    ext = np.full((4, 4, 3), 7, np.uint8)
    view.set_camera_source(
        lambda: CamInfo(ext, (0.0, 0.0, 50.0), 90.0))
    with sim.core.sh_state.lock():
        sim_snap = util.snapshot(sim.core.sh_state.sim)
    img, extent = view.frame(sim.env_app.env, sim_snap)
    assert img is ext

    # no CARLA client in this build: the bridge degrades with the
    # documented fallback instead of crashing the GUI
    view2 = BirdseyeView()
    with pytest.raises(RuntimeError, match="falls back"):
        view2.connect_carla()


def test_select_and_param_edit(sim_and_gui):
    sim, gui = sim_and_gui
    sim.update()

    # switch the active controller through the GUI, like the reference's
    # param selector (state_and_params.py:15-29)
    assert _post(gui, "/select",
                 {"controller": "const_acc_controller"}) == 200
    with sim.control_app.sh_controllers.lock():
        assert (sim.control_app.sh_controllers.active_controller
                == "const_acc_controller")

    # live param edit lands in the store the app reads each tick
    params = json.loads(_get(gui, "/params.json")[1])
    assert "path_vel_decomp_planner" in params["planning"]
    assert _post(gui, "/param",
                 {"target": "planning", "name": "path_vel_decomp_planner",
                  "param": "horizon", "value": 120}) == 200
    with sim.planning_app.sh_planners.lock():
        assert (sim.planning_app.sh_planners
                .path_vel_decomp_planner.params.horizon == 120)

    # unknown param is rejected
    with pytest.raises(urllib.error.HTTPError):
        _post(gui, "/param",
              {"target": "planning", "name": "path_vel_decomp_planner",
               "param": "nope", "value": 1})

    # sim run/pause toggle
    assert _post(gui, "/sim", {"running": False}) == 200
    with sim.core.sh_state.lock():
        assert sim.core.sh_state.sim.settings.running is False


def test_map_editor(sim_and_gui):
    """Map editor parity (reference: library/tpl/gui/views/map_editor.py):
    control-point editing, width/velocity fields, items, persistence."""
    sim, gui = sim_and_gui
    sim.update()

    # editor page + map listing
    status, body = _get(gui, "/editor")
    assert status == 200 and b"map editor" in body
    maps = json.loads(_get(gui, "/maps.json")[1])
    assert len(maps) > 0
    key = sorted(maps)[0]

    before = json.loads(_get(gui, f"/map.json?map={key}")[1])
    n_cp = len(before["control_points"])
    assert n_cp > 1 and len(before["path"]) > 1

    with sim.env_app.env.lock():
        rc_before = sim.env_app.env.reset_counter

    # move a control point; the map re-discretizes live
    cp = before["control_points"][1]
    assert _post(gui, "/map/edit",
                 {"op": "move_cp", "map": key, "index": 1,
                  "x": cp[0] + 0.5, "y": cp[1] + 0.5}) == 200
    after = json.loads(_get(gui, f"/map.json?map={key}")[1])
    assert after["control_points"][1][0] == pytest.approx(cp[0] + 0.5)

    # insert + delete keep the count consistent
    assert _post(gui, "/map/edit",
                 {"op": "insert_cp", "map": key, "index": 1,
                  "x": cp[0] + 1.0, "y": cp[1]}) == 200
    assert _post(gui, "/map/edit",
                 {"op": "delete_cp", "map": key, "index": 2}) == 200
    after = json.loads(_get(gui, f"/map.json?map={key}")[1])
    assert len(after["control_points"]) == n_cp

    # column edit (road width)
    assert _post(gui, "/map/edit",
                 {"op": "set_cp_field", "map": key, "field": "d_left",
                  "start": 0, "end": 2, "value": 4.5}) == 200
    after = json.loads(_get(gui, f"/map.json?map={key}")[1])
    assert after["control_points"][0][2] == 4.5

    # add + mutate + delete a velocity-limit item
    assert _post(gui, "/map/edit",
                 {"op": "add_item", "map": key, "kind": "velocity_limit",
                  "x": cp[0], "y": cp[1]}) == 200
    after = json.loads(_get(gui, f"/map.json?map={key}")[1])
    vls = [it for it in after["items"] if it["kind"] == "velocity_limit"]
    assert len(vls) >= 1
    uid = vls[-1]["uuid"]
    assert _post(gui, "/map/edit",
                 {"op": "set_item_field", "map": key, "uuid": uid,
                  "field": "limit", "value": 7.5}) == 200
    assert _post(gui, "/map/edit",
                 {"op": "delete_item", "map": key, "uuid": uid}) == 200

    # item manipulation on canvas: move an item, linked geometry follows
    assert _post(gui, "/map/edit",
                 {"op": "add_item", "map": key, "kind": "traffic_light",
                  "x": cp[0], "y": cp[1]}) == 200
    after = json.loads(_get(gui, f"/map.json?map={key}")[1])
    tl = [it for it in after["items"] if it["kind"] == "traffic_light"][-1]
    assert _post(gui, "/map/edit",
                 {"op": "move_item", "map": key, "uuid": tl["uuid"],
                  "x": cp[0] + 3.0, "y": cp[1] - 2.0}) == 200
    after = json.loads(_get(gui, f"/map.json?map={key}")[1])
    tl2 = [it for it in after["items"] if it["uuid"] == tl["uuid"]][0]
    assert tl2["pos"][0] == pytest.approx(cp[0] + 3.0)
    assert _post(gui, "/map/edit",
                 {"op": "delete_item", "map": key, "uuid": tl["uuid"]}) == 200

    # boundary drag: pull the left road edge outward at a path point;
    # the nearest control point's d_left widens to match
    before_bd = json.loads(_get(gui, f"/map.json?map={key}")[1])
    p0 = before_bd["path"][min(4, len(before_bd["path"]) - 1)]
    import math
    nx, ny = -math.sin(p0[2]), math.cos(p0[2])
    assert _post(gui, "/map/edit",
                 {"op": "drag_boundary", "map": key, "side": "left",
                  "x": p0[0] + nx * 6.0, "y": p0[1] + ny * 6.0}) == 200
    after = json.loads(_get(gui, f"/map.json?map={key}")[1])
    assert max(cpv[2] for cpv in after["control_points"]) == \
        pytest.approx(6.0, abs=0.3)

    # undo restores the pre-drag widths
    assert _post(gui, "/map/edit", {"op": "undo", "map": key}) == 200
    after = json.loads(_get(gui, f"/map.json?map={key}")[1])
    assert after["control_points"] == before_bd["control_points"]

    # every edit bumped reset_counter (planner warm starts invalidated)
    with sim.env_app.env.lock():
        assert sim.env_app.env.reset_counter > rc_before

    # persistence round-trip through a temp store path
    import tempfile, os
    from tpl_tpu_torch.environment.map_module import load_map_store
    with tempfile.TemporaryDirectory() as td:
        out = gui.map_editor.save(store_path=os.path.join(td, "edited"))
        assert os.path.isfile(os.path.join(out, "state.json"))
        store = load_map_store("edited", data_path=td)
        reloaded = util.get_obj_dict(store)
        assert key in reloaded
        assert reloaded[key].control_points[0][2] == 4.5


def test_paramset_selector(sim_and_gui):
    """Named param-set load/save through the GUI (reference param-set
    selector, gui/state_and_params.py:15-29); the vendored set is
    ``demo``."""
    import os
    import tempfile
    sim, gui = sim_and_gui
    sim.update()

    sets = json.loads(_get(gui, "/paramsets.json")[1])
    assert "demo" in sets["planning"]["names"]
    assert sets["planning"]["active"] in sets["planning"]["names"]

    # loading a set merges its values into the live store
    with sim.planning_app.sh_planners.lock():
        sim.planning_app.sh_planners \
            .path_vel_decomp_planner.params.horizon = 77
    assert _post(gui, "/paramset",
                 {"target": "planning", "name": "demo"}) == 200
    with sim.planning_app.sh_planners.lock():
        assert (sim.planning_app.sh_planners
                .path_vel_decomp_planner.params.horizon == 250)

    # saving under a new name creates a loadable set
    with tempfile.TemporaryDirectory() as td:
        old = util.PATH_PARAMS
        util.PATH_PARAMS = td
        try:
            assert _post(gui, "/paramset/save",
                         {"target": "planning", "name": "mytune"}) == 200
            assert os.path.isfile(
                os.path.join(td, "planning", "mytune", "state.json"))
            sets = json.loads(_get(gui, "/paramsets.json")[1])
            assert "mytune" in sets["planning"]["names"]
            assert _post(gui, "/paramset",
                         {"target": "planning", "name": "mytune"}) == 200
        finally:
            util.PATH_PARAMS = old


def test_renderer_hook_dispatch(sim_and_gui):
    """Per-store renderer plug-in pattern (reference resolves
    __renderer__ on each store value, planning_app.py:42): every planner
    publishes a resolvable hook with its bundle, and the active
    planner's debug geometry renders without planner-specific GUI
    code."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from tpl_tpu_torch.gui import renderers

    sim, gui = sim_and_gui
    store = sim.planning_app.sh_planners
    with store.lock():
        names = list(store.planner_names)

    for n in names:
        if n == "base_planner":
            continue
        with store.lock():
            spec = getattr(getattr(store, n), "__renderer__", None)
        assert spec, f"{n} publishes no __renderer__"
        assert renderers.resolve(spec) is not None, spec

    for planner in ["path_vel_decomp_planner", "dp_lat_lon_planner",
                    "idm_sampling_planner"]:
        with store.lock():
            store.active_planner = planner
        for _ in range(15):
            sim.update()
        with sim.env_app.env.lock():
            local_map = util.snapshot(sim.env_app.env.local_map)
        with store.lock():
            comp = util.snapshot(getattr(store, planner))
        fig, ax = plt.subplots()
        fn = renderers.resolve(comp["__renderer__"])
        fn(ax, comp, local_map)        # raises if the view is broken
        assert renderers.draw_component(ax, comp, local_map)
        plt.close(fig)


def test_event_log(sim_and_gui):
    """Event feed parity with the reference's VoiceLog announcer
    (library/tpl/gui/views/voice_log.py): environment resets, autonomy
    transitions, and planner reinit messages become timestamped events."""
    sim, gui = sim_and_gui
    sim.update()

    # prime the watcher with the current state
    assert json.loads(_get(gui, "/events.json")[1]) == []

    gui.event_log.min_interval = 0.0  # no rate limit in the test

    with sim.env_app.env.lock():
        sim.env_app.env.reset_counter += 1
    events = json.loads(_get(gui, "/events.json")[1])
    assert any("Environment reset" in e["msg"] for e in events)

    with sim.env_app.env.lock():
        sim.env_app.env.vehicle_state.automated = False
    events = json.loads(_get(gui, "/events.json")[1])
    assert any("disengaged" in e["msg"] for e in events)

    with sim.env_app.env.lock():
        sim.env_app.env.vehicle_state.imu_state = 2
    events = json.loads(_get(gui, "/events.json")[1])
    assert any("RTK floating" in e["msg"] for e in events)


def test_map_tile_background_layer(tmp_path):
    """The scene background layer draws cached imagery tiles at world
    extents and falls back to a coordinate grid without imagery
    (reference slot: gui/components/map_tiles_component.py)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np
    from tpl_tpu_torch.gui.map_tiles import TileLayer

    # seed one 100 m tile at (0, 0) in the cache layout
    tdir = tmp_path / "tiles" / "100"
    tdir.mkdir(parents=True)
    img = np.zeros((16, 16, 3), np.float32)
    img[:, :, 1] = 1.0
    plt.imsave(tdir / "0_0.png", img)

    layer = TileLayer(cache_dir=str(tmp_path / "tiles"), tile_m=100.0)
    assert (0, 0) in layer.tiles_in_view(-10, 50, -10, 50)

    fig, ax = plt.subplots()
    layer.draw(ax, -10, 110, -10, 110)
    # the seeded tile became an image at its world extent
    assert len(ax.images) == 1
    assert tuple(ax.images[0].get_extent()) == (0.0, 100.0, 0.0, 100.0)
    plt.close(fig)

    # no imagery -> procedural grid fallback (lines, no images)
    empty = TileLayer(cache_dir=str(tmp_path / "none"), tile_m=100.0)
    fig, ax = plt.subplots()
    empty.draw(ax, 0, 30, 0, 30)
    assert len(ax.images) == 0
    assert len(ax.lines) > 4
    plt.close(fig)


def test_optim_view_interactive():
    """Interactive optim-example GUI (reference:
    library/tpl/optim/examples/crane_2d/main.py:123-186 — imviz loop
    with draggable target, autogui params, simulate toggle): the HTTP
    counterpart re-solves per poll, writes dragged handles into solver
    params, and shifts the horizon when simulation is running."""
    from tpl_tpu_torch.examples import crane_2d as crane
    from tpl_tpu_torch.gui.optim_view import OptimView, Handle

    opt = crane.make_solver(device="cpu")
    opt.max_iterations = 10          # keep the test fast
    view = OptimView(
        opt, scene=crane.crane_scene,
        handles=[Handle("target_position", "point",
                        get=lambda o: (o.params.p_trg, 0.0),
                        set=lambda o, x, y: setattr(o.params,
                                                    "p_trg", x))],
        title="crane_2d", port=0).start()
    try:
        status, body = _get(view, "/")
        assert status == 200 and b"canvas" in body

        status, body = _get(view, "/state.json")
        assert status == 200
        st = json.loads(body)
        assert st["title"] == "crane_2d"
        assert st["runtime_ms"] > 0.0
        assert st["handles"][0]["xy"][0] == st["params"]["p_trg"]
        assert len(st["scene"]) == 4           # rope-end traj + crane
        assert st["internals"]["horizon"] == 100

        # dragging the target writes the param and moves the solution
        assert _post(view, "/drag",
                     {"name": "target_position",
                      "x": 4.0, "y": 0.3}) == 200
        st = json.loads(_get(view, "/state.json")[1])
        assert st["params"]["p_trg"] == 4.0

        # autogui analog: POST /set changes any scalar param
        assert _post(view, "/set",
                     {"name": "w_swing", "value": 3.5}) == 200
        st = json.loads(_get(view, "/state.json")[1])
        assert st["params"]["w_swing"] == 3.5

        # simulate toggle: the horizon shifts between polls
        assert _post(view, "/sim", {"running": True}) == 200
        x0_before = json.loads(
            _get(view, "/state.json")[1])["internals"]["x"][0]
        x0_after = json.loads(
            _get(view, "/state.json")[1])["internals"]["x"][0]
        assert x0_before != x0_after
    finally:
        view.stop()


# ---------------------------------------------------------------------
# the port's GUI against the JAX package's

RSTP = "path_vel_decomp_planner"
TICKS = 10
ATOL = 1e-3        # tests/test_torch_demo_loops.py


def _cut(sim):
    """tests/test_torch_demo_loops.py's cuts and settings."""
    store = sim.planning_app.sh_planners
    with store.lock():
        params = store.path_vel_decomp_planner.params
        params.horizon = 100
        params.collision_screen = False
    with sim.control_app.sh_controllers.lock():
        sim.control_app.sh_controllers.model_predictive_controller \
            .params.horizon = 20
    with sim.core.sh_state.lock():
        ss = sim.core.sh_state.sim
        ss.settings.running = True
        ss.settings.use_real_time = False
        ss.rule_checker.enable = True


def _state_after(sim_cls, gui_cls, ticks):
    sim = sim_cls(app_id=uuid.uuid4().hex[:8],
                  scenario_path="demo/country_follow")
    _cut(sim)
    for _ in range(ticks):
        sim.update()
    gui = gui_cls(port=0, env=sim.env_app.env, sim_store=sim.core.sh_state,
                  planning_store=sim.planning_app.sh_planners,
                  control_store=sim.control_app.sh_controllers).start()
    try:
        return json.loads(_get(gui, "/state.json")[1])
    finally:
        gui.stop()


def _keys(tree):
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    return type(tree).__name__


def test_state_json_matches_the_jax_gui():
    from tpl_tpu.gui import GuiServer as JaxGui
    from tpl_tpu.simulation import SimStandalone as JaxSim
    from tpl_tpu_torch.gui import GuiServer
    from tpl_tpu_torch.simulation import SimStandalone

    tpl_tpu_torch.use_device("cpu")
    np.random.seed(0)
    want = _state_after(JaxSim, JaxGui, TICKS)
    np.random.seed(0)
    got = _state_after(SimStandalone, GuiServer, TICKS)
    # the same keys, the same value types (runtimes included)
    assert _keys(got) == _keys(want)
    assert got["t"] == want["t"] == pytest.approx((TICKS - 1) * 0.01)
    for k in ("running", "n_cars", "violations"):
        assert got[k] == want[k], k
    for side in ("planning", "control"):
        for k in ("active", "names"):
            assert got[side][k] == want[side][k], (side, k)
    assert got["planning"]["active"] == RSTP
    ego = ("x", "y", "v", "yaw")
    np.testing.assert_allclose([got["ego"][k] for k in ego],
                               [want["ego"][k] for k in ego], rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(got["control"]["controls"],
                               want["control"]["controls"], rtol=0,
                               atol=ATOL)
    assert got["ego"]["v"] > 0.5

