"""
Multi-process application entry points.

The reference deploys environment / planning / control as separate
processes over shared-memory stores (reference: library/tpl/application/
*_app.py main() loops + structstore). Here each main runs its app loop
against the mmap-backed ShmStore/ShmObject substrate
(:mod:`tpl_tpu_torch.util.shm_store`, the stores named by
:func:`tpl_tpu_torch.util.store_paths`); a simulation (or a real vehicle's
interface) attaches with :class:`tpl_tpu_torch.simulation.SimAttach`, e.g.
``tplsim attach``, and the GUI with ``python -m tpl_tpu_torch.gui.main``.

Run e.g. (each in its own shell; ``--cpu`` solves on the CPU, else on the
card, which raises where there is none):
    python -m tpl_tpu_torch.application.mains env --app-id demo
    python -m tpl_tpu_torch.application.mains planning --app-id demo
    python -m tpl_tpu_torch.application.mains control --app-id demo
    python -m tpl_tpu_torch.simulation.tplsim attach --app-id demo \\
        --scenario demo/country_follow

The port of tpl_tpu/application/mains.py, with two differences where the
JAX loops cannot close across processes:

- the control process fills its own control input before each update (the
  sim time the env holds, a snapshot of the env's vehicle state, the
  planning store's trajectory), as ``SimStandalone`` does in one process;
  in the JAX package nobody fills it, and the controller solves on an
  empty input;
- the env process reads the time and runs its update under one lock: the
  JAX loop reads ``env.t`` under one lock and writes it back in the
  update's, so a sim tick that lands between the two is undone.
"""

import os
import sys
import time
import signal
import argparse

def _maybe_reload(update_fn):
    """Wrap an app update loop in the live code reloader, like the
    reference's minireload wrapper (reference: planning_app.py:131).
    Disable with TPL_TPU_NO_RELOAD=1."""
    if os.environ.get("TPL_TPU_NO_RELOAD"):
        return update_fn
    from tpl_tpu_torch.util.hotreload import WrappingReloader
    return WrappingReloader(update_fn)


def _shared_env(app_id):
    # the process substrate is shared memory in multi-process deployments
    # (every main opens the env first, before any store of the registry)
    os.environ.setdefault("TPL_TPU_SHM", "1")
    from tpl_tpu_torch.util import store_paths
    from tpl_tpu_torch.util.shm_store import ShmObject
    from tpl_tpu_torch.environment import EnvironmentState
    return ShmObject(EnvironmentState(), store_paths(app_id).env)


def exit_on_sigterm():
    """Makes SIGTERM end the process as ``sys.exit(0)`` does: the loop
    unwinds, so a store lock held at that moment is published and
    released."""
    def stop(signum, frame):
        sys.exit(0)
    signal.signal(signal.SIGTERM, stop)


def env_main(app_id="", env_params=None, max_ticks=None):
    from tpl_tpu_torch.application.environment_app import EnvironmentApp

    app = EnvironmentApp(app_id, env_params, env=_shared_env(app_id))
    update = _maybe_reload(app.update)
    ticks = 0
    while max_ticks is None or ticks < max_ticks:
        # one lock for the time and the update: EnvironmentApp.update
        # writes back the time it is given, and a sim tick between two
        # locks would be turned back
        with app.env.lock():
            update(app.env.t)
        time.sleep(0.001)
        ticks += 1


def planning_main(app_id="", planning_params=None, max_ticks=None):
    from tpl_tpu_torch.application.planning_app import PlanningApp
    shared_env = _shared_env(app_id)
    shared_env.revalidate()
    app = PlanningApp(app_id, planning_params, shared_env=shared_env)
    update = _maybe_reload(app.update)
    ticks = 0
    while max_ticks is None or ticks < max_ticks:
        shared_env.revalidate()
        update()
        ticks += 1


def fill_control_input(sh_input, shared_env, sh_planning):
    """The control input of one tick, the fields and snapshots of
    ``SimStandalone._step_control``: ``t`` and the vehicle state from the
    env store, the trajectory from the planning store (kept as it is until
    the planning app has published one).  Reads without the lock, so
    neither store is published again."""
    from tpl_tpu_torch.util import snapshot
    shared_env.revalidate()
    t = shared_env.t
    vehicle = snapshot(shared_env.vehicle_state)
    sh_planning.revalidate()
    trajectory = snapshot(getattr(sh_planning, "trajectory", None))
    with sh_input.lock():
        sh_input.t, sh_input.vehicle = t, vehicle
        if trajectory is not None:
            sh_input.trajectory = trajectory


def control_main(app_id="", control_params=None, max_ticks=None):
    from tpl_tpu_torch.application.control_app import ControlApp
    from tpl_tpu_torch.util import StoreRegistry, store_paths
    shared_env = _shared_env(app_id)
    app = ControlApp(app_id, control_params)
    sh_planning = StoreRegistry.get(store_paths(app_id).planning)
    update = _maybe_reload(app.update)
    ticks = 0
    while max_ticks is None or ticks < max_ticks:
        fill_control_input(app.sh_input, shared_env, sh_planning)
        update()
        time.sleep(0.001)
        ticks += 1


MAINS = {"env": env_main, "planning": planning_main,
         "control": control_main}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("app", choices=list(MAINS))
    parser.add_argument("--app-id", default="")
    parser.add_argument("--params", default=None)
    parser.add_argument("--max-ticks", type=int, default=None)
    parser.add_argument("--cpu", action="store_true",
                        help="run every solve on the CPU, not the card")
    args = parser.parse_args(argv)

    import tpl_tpu_torch
    tpl_tpu_torch.use_device("cpu" if args.cpu else "cuda")
    exit_on_sigterm()
    MAINS[args.app](args.app_id, args.params, args.max_ticks)


if __name__ == "__main__":
    main()
