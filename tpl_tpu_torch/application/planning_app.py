"""
Planning application: hosts the planner family, dispatches the active
planner each tick and publishes the resulting trajectory.

A planner exception propagates out of :meth:`PlanningApp.update`: there is
no device-error recovery here, so a kernel or device fault is never hidden
behind an emergency trajectory.

Behavioral parity target: library/tpl/application/planning_app.py.
"""

import time

from tpl_tpu_torch.application.registry import (
    ComponentRegistry, merge_param_set, save_param_set)
from tpl_tpu_torch.planning import BasePlanner, Trajectory
from tpl_tpu_torch.util import StoreRegistry, store_paths


class PlanningApp:

    def __init__(self, app_id="", planning_params_path=None,
                 shared_env=None):
        if shared_env is None:
            raise ValueError(
                "PlanningApp requires shared_env (single-process build)")
        self.app_id = app_id
        self.env = shared_env
        self.last_time = 0.0
        self.last_active_planner = ""
        self._warned_unknown = None

        self.sh_planners = StoreRegistry.get(store_paths(app_id).planning)
        with self.sh_planners.lock():
            self.registry = ComponentRegistry(
                self.sh_planners, BasePlanner, kind="planning",
                active_key="active_planner", names_key="planner_names")
            self.sh_planners.runtime = 0.0
            self.sh_planners.trajectory = Trajectory()
            self.registry.load_params(planning_params_path)

        self.planners = self.registry.by_name

    def update(self):
        tick_start = time.perf_counter()

        with self.env.lock():
            self.last_time = self.env.t

        name = self.registry.active_name()
        if name != self.last_active_planner:
            # planner switch: warm starts and reset counters of the
            # outgoing planner are meaningless to the incoming one
            with self.env.lock():
                self.env.reset()
            self.last_active_planner = name

        planner = self.registry.get(name)
        if planner is None and name:
            # An unknown selector must not leave the stale trajectory
            # in the store (the vehicle would keep tracking it and
            # drift): publish an emergency trajectory — routed to
            # ConstAccController — until a valid planner is selected.
            if name != self._warned_unknown:
                print(f"[planning] unknown active planner {name!r} "
                      f"(known: {sorted(self.planners)}); latching "
                      "emergency until a valid planner is selected",
                      flush=True)
                self._warned_unknown = name
            trajectory = Trajectory()
            trajectory.emergency = True
        else:
            trajectory = None if planner is None \
                else planner.update(self.env)

        # prefer the planner's own (device-side) timing when it has one
        runtime = getattr(planner, "runtime", None)
        if runtime is None:
            runtime = getattr(getattr(planner, "update", None),
                              "runtime", None)
        if runtime is None:
            runtime = time.perf_counter() - tick_start

        with self.sh_planners.lock():
            self.sh_planners.runtime = runtime
            if trajectory is not None:
                self.sh_planners.trajectory = trajectory
                self.sh_planners.has_new_traj = True


def load_planning_params(sh_planners, path=None):
    if path is None:
        path = getattr(sh_planners, "storage", "default")
    merge_param_set(sh_planners, "planning", "active_planner", path)


def save_planning_params(sh_planners):
    save_param_set(sh_planners, "planning", "active_planner",
                   sh_planners.planner_names)
