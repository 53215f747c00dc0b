"""The port's recorder / replay / renderer round trip: the cases of
tests/test_record_replay.py on the port (``tpl_tpu_torch.simulation``).
The JAX cases drive ``acc_2024/cv_3o``, which is not in the repository's
data: these drive ``demo/country_follow`` (the vendored RSTP planner and
MPC, the demo sets) and, as in the JAX case, ``demo/urban_light``.  A
recorder asked for video renders its frames through
``tpl_tpu_torch.simulation.renderer`` and saves them."""

import uuid

import numpy as np
import pytest

import tpl_tpu_torch


@pytest.fixture(autouse=True)
def on_the_cpu():
    tpl_tpu_torch.use_device("cpu")


def test_record_and_replay(tmp_path):
    np.random.seed(0)
    from tpl_tpu_torch.simulation import SimStandalone, SimRecorder, SimReplay
    from tpl_tpu_torch.simulation.record import load_recording

    app_id = uuid.uuid4().hex[:8]
    sim = SimStandalone(app_id=app_id, scenario_path="demo/country_follow")
    with sim.core.sh_state.lock():
        ss = sim.core.sh_state.sim
        ss.settings.running = True
        ss.settings.use_real_time = False
        ss.rule_checker.enable = True

    rec = SimRecorder(sim, str(tmp_path / "rec"), dt_state_log=0.01)
    for _ in range(20):
        sim.update()
        rec.capture()
    rec.finish()

    recording = load_recording(str(tmp_path / "rec"))
    assert len(recording.sim_states) >= 10
    assert len(recording.runtime_planner) == len(recording.sim_states)
    assert (tmp_path / "rec" / "runtime_stats.txt").exists()

    # replay into a fresh store
    from tpl_tpu_torch.util import Store
    store = Store()
    rep = SimReplay(app_id=uuid.uuid4().hex[:8],
                    recording_path=str(tmp_path / "rec"), sim_store=store)
    with rep.sh_replay.lock():
        rep.sh_replay.state.sleep_time = 0.0
    step = rep.update()
    assert step == 1
    with store.lock():
        assert store.sim.t == recording.sim_states[1].t


def test_renderer(tmp_path):
    np.random.seed(0)
    from tpl_tpu_torch.simulation import SimStandalone
    from tpl_tpu_torch.simulation.renderer import render_scene, render_occ_map

    app_id = uuid.uuid4().hex[:8]
    sim = SimStandalone(app_id=app_id, scenario_path="demo/country_follow")
    with sim.core.sh_state.lock():
        ss = sim.core.sh_state.sim
        ss.settings.running = True
        ss.settings.use_real_time = False
    sim.update()

    with sim.core.sh_state.lock():
        s = sim.core.sh_state.sim
        frame = render_scene(sim.env_app.env, s,
                             planners=sim.planning_app.sh_planners)
    assert frame.ndim == 3 and frame.shape[2] == 3
    assert frame.shape[0] > 100

    occ = np.zeros((10, 201, 21))
    occ[0, 50:60, 8:12] = 1.0
    out = render_occ_map(occ, path=str(tmp_path / "occ.png"))
    assert (tmp_path / "occ.png").exists()


def test_scene_renderer_components():
    """The stateful renderer draws the full component set (tracked
    objects + predictions + history, traffic lights, map items,
    corridor overlay) without error and trails accumulate."""
    np.random.seed(0)
    from tpl_tpu_torch.simulation import SimStandalone
    from tpl_tpu_torch.simulation.renderer import SceneRenderer

    app_id = uuid.uuid4().hex[:8]
    # urban scenario: traffic light + crosswalk + crossing traffic
    sim = SimStandalone(app_id=app_id, scenario_path="demo/urban_light")
    with sim.core.sh_state.lock():
        ss = sim.core.sh_state.sim
        ss.settings.running = True
        ss.settings.use_real_time = False

    renderer = SceneRenderer(history_len=10)
    for _ in range(12):
        sim.update()
    with sim.core.sh_state.lock():
        s = sim.core.sh_state.sim
        frame = renderer(sim.env_app.env, s,
                         planners=sim.planning_app.sh_planners)
        frame2 = renderer(sim.env_app.env, s,
                          planners=sim.planning_app.sh_planners)
    assert frame.ndim == 3 and frame.shape[2] == 3
    assert frame2.shape == frame.shape
    assert len(renderer.ego_history) == 2


def test_recorder_renders_video_frames(tmp_path):
    np.random.seed(0)
    from tpl_tpu_torch.simulation import SimStandalone, SimRecorder

    sim = SimStandalone(app_id=uuid.uuid4().hex[:8],
                        scenario_path="demo/country_follow")
    with sim.core.sh_state.lock():
        ss = sim.core.sh_state.sim
        ss.settings.running = True
        ss.settings.use_real_time = False
    rec = SimRecorder(sim, str(tmp_path / "video"), dt_state_log=0.01,
                      render_video=True)
    for _ in range(3):
        sim.update()
        rec.capture()
    rec.finish()
    frames = sorted((tmp_path / "video" / "frames").glob("frame_*.png"))
    assert len(frames) == len(rec.frames) >= 2
    assert rec.frames[0].ndim == 3 and rec.frames[0].shape[2] == 3
