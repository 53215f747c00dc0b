"""
tplsim CLI: run closed-loop simulation scenarios headlessly, drive apps
that run as other processes, or replay a recording into the sim store.

Usage:
    python -m tpl_tpu_torch.simulation.tplsim run \
        --scenario demo/country_follow --headless --max-t 25 [--cpu]
    python -m tpl_tpu_torch.simulation.tplsim attach \
        --scenario demo/country_follow --app-id demo --max-t 25
    python -m tpl_tpu_torch.simulation.tplsim replay --recording DIR

The run takes the card (``tpl_tpu_torch.use_device("cuda")``, which raises
where there is none); ``--cpu`` runs every solve on the CPU instead.
``attach`` solves nothing itself: it ticks the sim against the env,
planning and control processes of ``tpl_tpu_torch.application.mains``
started with the same ``--app-id``, over shared-memory stores.  Both print
the rule violations at the end and exit 1 if there were any.
(reference: library/tpl/simulation/tplsim; the port of
tpl_tpu/simulation/tplsim.py)
"""

import sys
import time
import argparse

import numpy as np


def run(args):
    import tpl_tpu_torch
    tpl_tpu_torch.use_device("cpu" if args.cpu else "cuda")

    from tpl_tpu_torch.simulation import SimStandalone

    if args.seed is not None:
        np.random.seed(args.seed)

    sim = SimStandalone(app_id=args.app_id, scenario_path=args.scenario)
    return _drive(sim, sim.core, sim.planning_app.sh_planners, args)


def _drive(sim, core, planning, args):
    """Starts the loaded scenario (running, real time unless headless, the
    rule checker on), selects ``args.planner`` in the store ``planning``,
    ticks ``sim.update`` until the scenario finishes or ``--max-t`` /
    ``--max-ticks``, and prints the summary; returns the exit code."""
    with core.sh_state.lock():
        ss = core.sh_state.sim
        ss.settings.running = True
        ss.settings.use_real_time = not args.headless
        ss.settings.reload_if_finished = False
        ss.rule_checker.enable = True

    if args.planner:
        with planning.lock():
            names = list(planning.planner_names)
            if args.planner not in names:
                raise SystemExit(f"unknown planner {args.planner!r}; "
                                 f"available: {sorted(names)}")
            planning.active_planner = args.planner

    t_start = time.time()
    ticks = 0
    planner_runtimes = []

    # live code reloading, like the reference's minireload wrapper
    # (reference: library/tpl/simulation/tplsim:40-45)
    update = sim.update
    if not args.no_reload:
        from tpl_tpu_torch.util.hotreload import WrappingReloader
        update = WrappingReloader(sim.update)

    while True:
        update()
        ticks += 1

        with core.sh_state.lock():
            s = core.sh_state.sim
            sim_t = s.t
            finished = s.finished
            n_viol = len(s.rule_checker.violations)

        # read without the lock: a shared store publishes on every lock
        planning.revalidate()
        planner_runtimes.append(planning.runtime)

        if args.verbose and ticks % 100 == 0:
            print(f"t={sim_t:6.2f}s ticks={ticks} violations={n_viol} "
                  f"planner={planner_runtimes[-1]*1e3:.1f}ms", flush=True)

        if finished or (args.max_t and sim_t >= args.max_t):
            break
        if args.max_ticks and ticks >= args.max_ticks:
            break

    with core.sh_state.lock():
        s = core.sh_state.sim
        viols = s.rule_checker.violations

    rt = np.array(planner_runtimes[5:]) * 1e3
    print(f"\nscenario {args.scenario}: t={s.t:.2f}s ticks={ticks} "
          f"wall={time.time()-t_start:.1f}s finished={bool(finished)}")
    print(f"planner runtime ms: mean={rt.mean():.2f} std={rt.std():.2f} "
          f"p99={np.percentile(rt, 99):.2f} max={rt.max():.2f}")
    print(f"rule violations: {len(viols)}")
    for v in viols[:10]:
        print(" ", v)
    return 0 if len(viols) == 0 else 1


def attach(args):
    """Drive externally running apps over shared memory: the sim of
    :func:`run`, its physics against the apps of
    ``tpl_tpu_torch.application.mains``.  (reference: tplsim attach)"""
    import os
    os.environ.setdefault("TPL_TPU_SHM", "1")
    from tpl_tpu_torch.simulation.record import SimAttach

    if args.seed is not None:
        np.random.seed(args.seed)
    sim = SimAttach(app_id=args.app_id, scenario_path=args.scenario)
    return _drive(sim, sim.core, sim.sh_planning, args)


def replay(args):
    """Replay a recording into the sim store. (reference: tplsim replay)"""
    from tpl_tpu_torch.simulation.record import SimReplay

    rep = SimReplay(app_id=args.app_id, recording_path=args.recording)
    while True:
        step = rep.update()
        if step >= len(rep.recording.sim_states) - 1:
            break


def main():
    parser = argparse.ArgumentParser(prog="tplsim")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_run = sub.add_parser("run")
    p_run.add_argument("--scenario", default="default")
    p_run.add_argument("--planner", default=None,
                       help="active planner name (e.g. dp_lat_lon_planner)")
    p_run.add_argument("--app-id", default="tplsim")
    p_run.add_argument("--headless", action="store_true")
    p_run.add_argument("--cpu", action="store_true",
                       help="run every solve on the CPU, not the card")
    p_run.add_argument("--max-t", type=float, default=None)
    p_run.add_argument("--max-ticks", type=int, default=None)
    p_run.add_argument("--seed", type=int, default=0)
    p_run.add_argument("--verbose", action="store_true", default=True)
    p_run.add_argument("--no-reload", action="store_true",
                       help="disable live code reloading")

    p_att = sub.add_parser("attach")
    p_att.add_argument("--scenario", default="default")
    p_att.add_argument("--planner", default=None,
                       help="active planner name (e.g. dp_lat_lon_planner)")
    p_att.add_argument("--app-id", default="")
    p_att.add_argument("--headless", action="store_true")
    p_att.add_argument("--max-t", type=float, default=None)
    p_att.add_argument("--max-ticks", type=int, default=None)
    p_att.add_argument("--seed", type=int, default=0)
    p_att.add_argument("--verbose", action="store_true", default=True)
    p_att.add_argument("--no-reload", action="store_true",
                       help="disable live code reloading")

    p_rep = sub.add_parser("replay")
    p_rep.add_argument("--recording", required=True)
    p_rep.add_argument("--app-id", default="")

    args = parser.parse_args()
    if args.cmd == "run":
        sys.exit(run(args))
    elif args.cmd == "attach":
        sys.exit(attach(args))
    elif args.cmd == "replay":
        replay(args)


if __name__ == "__main__":
    main()
