"""The JAX package's own closed loops on the CPU on the four demo scenarios
that the port's ``chip_smoke.py`` drives on the card through ``tplsim run
--headless`` (its ``DEMO_JAX_END`` pins what this prints).

    JAX_PLATFORMS=cpu python tests/jax_demo_loops.py [TICKS]

For each of ``demo/oval_lap``, ``demo/leader_brake``, ``demo/urban_light``
and ``demo/urban_crossing``: ``SimStandalone`` with the scenario's own sets
as they are (the RSTP planner, fused, H = 250, its collision screen as the
set has it; the spatial MPC, H = 60), running, not in real time, the rule
checker on, numpy seeded with 0 (``tplsim run --seed 0``), for TICKS ticks
(default 200); prints the end time, ego x, y and speed, the rule
violations (the first of them) and the ticks with an emergency plan.  Not
a test: it imports JAX, which the card's machine lacks.
"""

import os
import sys
import uuid

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SCENARIOS = ("demo/oval_lap", "demo/leader_brake", "demo/urban_light",
             "demo/urban_crossing")


def loop_end(scenario, ticks):
    from tpl_tpu.simulation import SimStandalone

    np.random.seed(0)
    sim = SimStandalone(app_id=uuid.uuid4().hex[:8], scenario_path=scenario)
    store = sim.planning_app.sh_planners
    with store.lock():
        screen = store.path_vel_decomp_planner.params.collision_screen
    with sim.core.sh_state.lock():
        ss = sim.core.sh_state.sim
        ss.settings.running = True
        ss.settings.use_real_time = False
        ss.settings.reload_if_finished = False
        ss.rule_checker.enable = True
    emergency = 0
    for _ in range(ticks):
        sim.update()
        store.revalidate()
        emergency += bool(store.trajectory.emergency)
    with sim.core.sh_state.lock():
        s = sim.core.sh_state.sim
        return (s.t, s.ego.x, s.ego.y, s.ego.v,
                list(s.rule_checker.violations), emergency, screen)


if __name__ == "__main__":
    ticks = int(sys.argv[1]) if len(sys.argv) > 1 else 200
    for scenario in SCENARIOS:
        t, x, y, v, viol, emergency, screen = loop_end(scenario, ticks)
        print(f"{scenario}: {ticks} ticks to t={t:.2f} s, x {x:.4f} "
              f"y {y:.4f} v {v:.4f}, {len(viol)} violations"
              + (f" (first: {viol[0]})" if viol else "")
              + f", {emergency} emergency ticks; collision screen "
              f"{'on' if screen else 'off'}", flush=True)
