"""The port's multi-process deployment for the tests
(``tests/test_torch_multiprocess.py``, ``tests/test_torch_gui.py``, and on
the card ``tests/test_torch_kernel_cuda.py``): the three mains of
``tpl_tpu_torch.application.mains`` as child processes under one app id,
and a ``SimAttach`` ticked in the test's own process.  Imports only the
port."""

import os
import signal
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
APPS = ("env", "planning", "control")

# the cuts of tests/test_torch_closed_loop.py: the vendored RSTP planner
# at 100 steps with its collision screen off, the MPC at 20 steps
RSTP = "path_vel_decomp_planner"
RSTP_HORIZON = 100
MPC_HORIZON = 20

# a child that dumps its threads' stacks on SIGUSR1 (read after a stall)
# and prints its kernel launch counters as its last line when it ends
_CHILD = """
import faulthandler, json, signal, sys
faulthandler.register(signal.SIGUSR1, all_threads=True)
from tpl_tpu_torch.application.mains import main
from tpl_tpu_torch.optim import ilqr_rstp, ilqr_tracking_mpc
from tpl_tpu_torch.planning.path_vel_decomp import rstp_rampify
try:
    main(sys.argv[1:])
finally:
    print(json.dumps({"ilqr_rstp": ilqr_rstp.launches,
                      "rstp_rampify": rstp_rampify.launches,
                      "ilqr_tracking_mpc": ilqr_tracking_mpc.launches}),
          flush=True)
"""


def child_env(**extra):
    """The environment of a child process: the port importable, shared
    stores, no live reloader, one torch thread, the engine the test
    process uses."""
    env = dict(os.environ, PYTHONPATH=REPO, TPL_TPU_SHM="1",
               TPL_TPU_NO_RELOAD="1", OMP_NUM_THREADS="1")
    env.update(extra)
    return env


def _two_cores():
    # the apps' loops never idle: held to two cores, they leave the others
    # to the rest of a parallel test run (whose barrier-bound CPU
    # rehearsal of the kernels slows badly when its threads are preempted)
    os.sched_setaffinity(0, sorted(os.sched_getaffinity(0))[-2:])


def start_mains(app_id, cpu=True):
    """Starts the env, planning and control mains under ``app_id``, with
    ``--cpu`` (on two cores) unless ``cpu`` is False (then on the card);
    returns {name: Popen}."""
    flags = ["--cpu"] if cpu else []
    return {name: subprocess.Popen(
        [sys.executable, "-c", _CHILD, name, *flags, "--app-id", app_id],
        cwd=REPO, env=child_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
        preexec_fn=_two_cores if cpu else None) for name in APPS}


def launches(text):
    """The launch counters a child printed as its last line."""
    import json
    return json.loads(text.strip().splitlines()[-1])


def stop_mains(procs, timeout=30.0):
    """SIGTERM to every child, then their exit codes and output; a child
    that does not end in ``timeout`` s is killed (and reported as such)."""
    for p in procs.values():
        if p.poll() is None:
            p.terminate()
    out = {}
    for name, p in procs.items():
        try:
            text, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            text, _ = p.communicate()
            text += "\n(killed after SIGTERM)"
        out[name] = (p.returncode, text)
    return out


def dump_stacks(procs):
    for p in procs.values():
        if p.poll() is None:
            p.send_signal(signal.SIGUSR1)
    time.sleep(1.0)


def cut_and_start(sim, cut=True):
    """After ``SimAttach`` loaded the scenario: the cuts above (unless
    ``cut`` is False), written into the apps' stores (the planning and
    control processes take them into the bundles they hold), and the sim
    running in virtual time with the rule checker on."""
    with sim.sh_planning.lock():
        assert sim.sh_planning.active_planner == RSTP
        params = sim.sh_planning.path_vel_decomp_planner.params
        if cut:
            params.horizon = RSTP_HORIZON
            params.collision_screen = False
    if cut:
        with sim.sh_control.lock():
            sim.sh_control.model_predictive_controller.params.horizon = \
                MPC_HORIZON
    with sim.core.sh_state.lock():
        ss = sim.core.sh_state.sim
        ss.settings.running = True
        ss.settings.use_real_time = False
        ss.rule_checker.enable = True


def wait_for_plan(sim, procs, points, timeout=180.0):
    """Waits until the planning process has published a plan of
    ``points`` points (its first replan after the cuts; a fresh process's
    first replan pays torch's first-use imports, seconds on a busy CPU)."""
    start = time.time()
    while True:
        sim.sh_planning.revalidate()
        if len(sim.sh_planning.trajectory.x) == points:
            return
        _check(procs, start, timeout, f"a plan of {points} points")


def paced_tick(sim, control_input, procs, timeout=60.0):
    """One sim tick, then waits until the control process has taken this
    tick's time into its input and published a solve since: the apps run
    free, the sim waits for the controller (the pacing of the tests, not
    of the library).  Raises with the children's stacks after
    ``timeout`` s."""
    sim.update()
    with sim.core.sh_state.lock():
        t = sim.core.sh_state.sim.t
    start = time.time()
    while True:
        control_input.revalidate()
        if control_input.t >= t:
            break
        _check(procs, start, timeout, f"control input at t={t}")
    version = sim.sh_control.shm_version()
    while sim.sh_control.shm_version() == version:
        _check(procs, start, timeout, f"a control solve at t={t}")
    return t


def _check(procs, start, timeout, what):
    for name, p in procs.items():
        if p.poll() is not None:
            raise AssertionError(f"the {name} process ended ({p.returncode})"
                                 f" while waiting for {what}")
    if time.time() - start > timeout:
        dump_stacks(procs)
        raise AssertionError(f"no {what} in {timeout} s")
    time.sleep(0.001)
