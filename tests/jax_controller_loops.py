"""The JAX package's own closed loops on the CPU, one per controller that
the port's ``chip_smoke.py`` drives on the card (its ``CONTROLLER_JAX_END``
pins what this prints).

    JAX_PLATFORMS=cpu python tests/jax_controller_loops.py [TICKS] [--no-screen]

For each of the four controllers of the demo control set besides the
spatial MPC, ``SimStandalone`` on ``demo/country_follow`` with the
scenario's own planning set (the RSTP planner, fused, H=250) and that
controller active, rule checker on, for TICKS ticks (default 200); prints
the end time, ego x, y and speed, the rule violations (the first of them)
and the ticks with an emergency plan, and the range of the last plan's
time steps.  The scenario's sets are left as they are: the planner's
collision screen latches the hard brake over ticks 4-103 (in both
packages), and while it does the constant-deceleration fallback drives.
``--no-screen`` turns the screen off: then the time-indexed MPC leaves the
road in both packages, because it reads the plan as sampled every
``ref_dt`` = 0.1 s while the RSTP plan is sampled every 0.5 m.  Not a test:
it imports JAX, which the card's machine lacks.
"""

import os
import sys
import uuid

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CONTROLLERS = ("model_predictive_controller_time", "feedforward_controller",
               "flat_controller", "direct_controller")


def loop_end(name, ticks, screen=True):
    from tpl_tpu.simulation import SimStandalone

    np.random.seed(0)
    sim = SimStandalone(app_id=uuid.uuid4().hex[:8],
                        scenario_path="demo/country_follow")
    store = sim.planning_app.sh_planners
    with store.lock():
        store.path_vel_decomp_planner.params.collision_screen = screen
    with sim.control_app.sh_controllers.lock():
        sim.control_app.sh_controllers.active_controller = name
    with sim.core.sh_state.lock():
        ss = sim.core.sh_state.sim
        ss.settings.running = True
        ss.settings.use_real_time = False
        ss.rule_checker.enable = True
    emergency = 0
    for _ in range(ticks):
        sim.update()
        with store.lock():
            emergency += bool(store.trajectory.emergency)
            dt = np.diff(store.trajectory.time)
    with sim.core.sh_state.lock():
        s = sim.core.sh_state.sim
        return (s.t, s.ego.x, s.ego.y, s.ego.v,
                list(s.rule_checker.violations), emergency,
                (float(dt.min()), float(dt.max())) if len(dt) else None)


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    ticks = int(args[0]) if args else 200
    for name in CONTROLLERS:
        t, x, y, v, viol, emergency, steps = loop_end(
            name, ticks, screen="--no-screen" not in sys.argv)
        print(f"{name}: {ticks} ticks to t={t:.2f} s, x {x:.4f} y {y:.4f} "
              f"v {v:.4f}, {len(viol)} violations"
              + (f" (first: {viol[0]})" if viol else "")
              + f", {emergency} emergency ticks; the last plan's time steps "
              f"{steps[0]:.4f}-{steps[1]:.4f} s", flush=True)
