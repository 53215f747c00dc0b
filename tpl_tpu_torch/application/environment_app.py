"""
Environment application: owns the shared environment store and runs the
perception pipeline each tick.

The tick is a fixed stage list over the env store: map windowing first
(everything downstream works in the local-map frame), then the stateful
filters (tracking, prediction — only when time actually advanced), then
the derived map annotations.

Behavioral parity target: library/tpl/application/environment_app.py.
"""

import os.path as osp

from tpl_tpu_torch import util
from tpl_tpu_torch.environment import (
    PredictionModule, SharedEnvironmentState, TrackingModule, map_module)


class EnvironmentApp:

    def __init__(self, app_id="", env_params_path=None, env=None):
        """``env``: the shared environment to run on (the multi-process
        deployment passes its shared-memory one); an in-process one if
        None."""
        self.app_id = app_id
        self.last_time = -1.0

        self.env = SharedEnvironmentState() if env is None else env
        with self.env.lock():
            self.env.storage = "default"
            load_env_params(self.env, env_params_path)

        self._fresh_perception()

    def _fresh_perception(self):
        """(Re)create the stateful perception filters."""
        self.tracking_module = TrackingModule()
        self.prediction_module = PredictionModule()

    def _stages(self, fresh_time):
        """The per-tick pipeline, in execution order.  The stateful
        filters advance only on fresh timestamps: re-running a KF or a
        predictor on a repeated clock would double-integrate."""
        yield map_module.update_local_map
        if fresh_time:
            yield self.tracking_module.update
            yield self.prediction_module.update
        yield map_module.update_map_items
        yield map_module.update_local_map_velocity
        yield map_module.update_local_map_inters_paths

    def update(self, t):
        if t < self.last_time:
            # time ran backwards (scenario reset / replay): every
            # perception filter state is stale
            self._fresh_perception()
            self.last_time = 0.0

        with self.env.lock():
            self.env.t = t
            for stage in self._stages(fresh_time=self.last_time != t):
                stage(self.env)

        self.last_time = t


def load_env_params(sh_env, path=None):
    """Load an env param set (map store path + selected map) and the map
    store it points at."""
    if path is None:
        path = getattr(sh_env, "storage", "default")
    if not path:
        return False
    data = util.load_state_dict(
        util.resolve_data("params", osp.join("env", path)))
    if data is None:
        return False

    sh_env.storage = path
    for key in ("map_store_path", "selected_map"):
        if key in data:
            setattr(sh_env, key, data[key])

    maps = map_module.load_map_store(sh_env.map_store_path)
    if list(util.get_obj_dict(maps)):
        sh_env.maps = maps
    else:
        sh_env.map_store_path = ""
        sh_env.maps = util.Bundle()
    return True
