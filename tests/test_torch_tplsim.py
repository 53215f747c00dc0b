"""The port's framework tooling: the ``tplsim`` command line, the recorder
and replay, and live code reloading.

- ``python -m tpl_tpu_torch.simulation.tplsim run --scenario
  demo/country_follow --headless --cpu --no-reload --max-ticks N`` in a
  fresh interpreter: it exits 0, prints its summary, and leaves no ``jax``
  or ``tpl_tpu`` in ``sys.modules``; without ``--cpu`` on a machine with no
  card it raises and never drops to the CPU.
- ``SimRecorder`` records a short loop of the port's ``SimStandalone``;
  ``load_recording`` reads it back and ``SimReplay`` (also through
  ``tplsim replay``) steps it into a store state for state.  A recorder
  asked for video draws its frames with the scene renderer, which needs
  matplotlib (where matplotlib is missing the capture raises its
  ImportError).
- The three cases of tests/test_hotreload.py against the port's
  ``WrappingReloader``, as one parametrised test: live instances and
  imported references take an edit, a broken edit keeps the old code, an
  exception in the wrapped call is caught.
"""

import os
import subprocess
import sys
import textwrap
import uuid

import numpy as np
import pytest
import torch

import tpl_tpu_torch
from tpl_tpu_torch.simulation import (
    SimRecorder, SimReplay, SimStandalone, load_recording)
from tpl_tpu_torch.simulation import tplsim
from tpl_tpu_torch.util import Store
from tpl_tpu_torch.util.hotreload import WrappingReloader

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TICKS = 12

# runs tplsim as ``python -m`` does, then reports the modules it loaded
_RUN = r"""
import runpy, sys
sys.argv = ["tplsim"] + sys.argv[1:]
try:
    runpy.run_module("tpl_tpu_torch.simulation.tplsim", run_name="__main__")
    code = 0
except SystemExit as e:
    code = e.code
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "tpl_tpu"))
print("leaked", leaked)
sys.exit(code)
"""


def _tplsim(*args):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-c", _RUN, *args], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_tplsim_run_headless_on_the_cpu():
    res = _tplsim("run", "--scenario", "demo/country_follow", "--headless",
                  "--cpu", "--no-reload", "--max-ticks", str(TICKS))
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-4000:]
    out = res.stdout
    assert f"scenario demo/country_follow: t=0.11s ticks={TICKS}" in out
    assert "planner runtime ms: mean=" in out
    assert "rule violations: 0" in out
    assert "leaked []" in out


def test_tplsim_run_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("checks the run on a machine without a card")
    res = _tplsim("run", "--scenario", "demo/country_follow", "--headless",
                  "--no-reload", "--max-ticks", "1")
    assert res.returncode != 0
    assert "CUDA is not available" in res.stderr
    assert "rule violations" not in res.stdout


@pytest.fixture(scope="module")
def recording(tmp_path_factory):
    """A recorded loop of the port's sim (the RSTP planner, horizon cut to
    100 steps): (recorder path, the sim states as they were)."""
    tpl_tpu_torch.use_device("cpu")
    np.random.seed(0)
    sim = SimStandalone(app_id=uuid.uuid4().hex[:8],
                        scenario_path="demo/country_follow")
    with sim.planning_app.sh_planners.lock():
        sim.planning_app.sh_planners.path_vel_decomp_planner.params \
            .horizon = 100
    with sim.core.sh_state.lock():
        ss = sim.core.sh_state.sim
        ss.settings.running = True
        ss.settings.use_real_time = False
        ss.rule_checker.enable = True
    path = str(tmp_path_factory.mktemp("rec") / "rec")
    rec = SimRecorder(sim, path, dt_state_log=0.01)
    seen = []
    for _ in range(TICKS):
        sim.update()
        rec.capture()
        with sim.core.sh_state.lock():
            s = sim.core.sh_state.sim
            seen.append((s.t, s.ego.x, s.ego.y, s.ego.v))
    rec.finish()
    return path, seen


def test_recorder_writes_every_tick(recording):
    path, seen = recording
    rec = load_recording(path)
    assert len(rec.sim_states) == len(seen)
    assert len(rec.runtime_planner) == len(rec.sim_states)
    assert set(rec.active_planner) == {"path_vel_decomp_planner"}
    assert set(rec.active_controller) == {"model_predictive_controller"}
    assert os.path.exists(os.path.join(path, "runtime_stats.txt"))
    for s, want in zip(rec.sim_states, seen):
        assert (s.t, s.ego.x, s.ego.y, s.ego.v) == want
        assert s.manager is None


def test_replay_steps_the_recording_state_for_state(recording):
    path, seen = recording
    store = Store()
    rep = SimReplay(app_id=uuid.uuid4().hex[:8], recording_path=path,
                    sim_store=store)
    with rep.sh_replay.lock():
        rep.sh_replay.state.sleep_time = 0.0
    with store.lock():
        assert store.sim.t == seen[0][0]
        assert store.sim.settings.running is False
    for k in range(1, len(seen)):
        assert rep.update() == k
        with store.lock():
            s = store.sim
            assert (s.t, s.ego.x, s.ego.y, s.ego.v) == seen[k]
    assert rep.update() == len(seen) - 1      # holds at the last state
    # paused: the step stays
    with rep.sh_replay.lock():
        rep.sh_replay.state.running = False
    assert rep.update() == len(seen) - 1


def test_tplsim_replay_runs_to_the_end(recording, monkeypatch):
    path, _ = recording
    monkeypatch.setattr(sys, "argv", ["tplsim", "replay", "--recording",
                                      path, "--app-id", uuid.uuid4().hex[:8]])
    assert tplsim.main() is None


def test_recorder_video_needs_the_renderer(tmp_path):
    tpl_tpu_torch.use_device("cpu")
    sim = SimStandalone(app_id=uuid.uuid4().hex[:8],
                        scenario_path="demo/country_follow")
    with sim.core.sh_state.lock():
        sim.core.sh_state.sim.t = 0.1
    rec = SimRecorder(sim, str(tmp_path / "video"), render_video=True)
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="matplotlib"):
            rec.capture()
        return
    rec.capture()
    assert len(rec.frames) == 1
    assert rec.frames[0].ndim == 3 and rec.frames[0].shape[2] == 3


# ---------------------------------------------------------------------
# live code reloading (tests/test_hotreload.py)

INITIAL = """
    VALUE = 1

    def free_fn():
        return 10

    class Planner:
        def step(self):
            return VALUE + self.offset()

        def offset(self):
            return 0
"""
EDITED = """
    VALUE = 2

    def free_fn():
        return 20

    class Planner:
        def step(self):
            return VALUE + self.offset()

        def offset(self):
            return 100

        def brand_new(self):
            return "new"
"""
FIXED = INITIAL.replace("VALUE = 1", "VALUE = 7")
RAISING = INITIAL.replace("return VALUE + self.offset()",
                          'raise RuntimeError("live bug")')


@pytest.fixture
def live_module(tmp_path, monkeypatch):
    """A watchable throwaway module whose source the test rewrites."""
    name = "torch_hotreload_target_" + uuid.uuid4().hex[:8]
    path = tmp_path / f"{name}.py"
    monkeypatch.syspath_prepend(str(tmp_path))
    mtime = [100]

    def write(src):
        path.write_text(textwrap.dedent(src))
        # a strictly increasing mtime (the file system's granularity can
        # swallow rewrites within a millisecond)
        mtime[0] += 1
        os.utime(path, ns=(mtime[0] * 10 ** 9, mtime[0] * 10 ** 9))

    write(INITIAL)
    module = __import__(name)
    yield module, write
    sys.modules.pop(name, None)


# (the edits written one after the other, the wrapped call's result after
# each)
CASES = {
    "instances_and_refs_update": ([EDITED], [102]),
    "broken_edit_keeps_old_code": (["def broken(:\n", FIXED], [1, 7]),
    "wrapped_exception_is_caught": ([RAISING], [None]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_wrapping_reloader(live_module, capsys, case):
    module, write = live_module
    planner = module.Planner()
    free_ref = module.free_fn           # as `from mod import free_fn`
    reloader = WrappingReloader(planner.step, watch=(module.__name__,),
                                poll_interval=0.0, verbose=False)
    assert reloader.watch == (module.__name__,)
    assert WrappingReloader(planner.step).watch == ("tpl_tpu_torch",)
    assert reloader() == 1
    edits, results = CASES[case]
    for src, want in zip(edits, results):
        write(src)
        assert reloader() == want
        assert module.Planner          # the namespace survives
    if case == "instances_and_refs_update":
        # the live instance, its bound method and the imported function
        # run the new code; the class keeps its identity
        assert free_ref() == 20
        assert planner.brand_new() == "new"
        assert isinstance(planner, module.Planner)
    elif case == "wrapped_exception_is_caught":
        assert "live bug" in capsys.readouterr().err
