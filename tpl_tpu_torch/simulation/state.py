"""
Simulation state schema and scenario persistence.

The scenario format is shared with the reference (a scenario directory
is a frozen sim state in objtoolbox ``state.json`` form plus an optional
``manager.py`` script), so the field names and defaults below are fixed
by that on-disk contract (reference: library/tpl/simulation/state.py).
The code around the schema is this framework's own: dataclasses, one
shared oriented-box footprint helper, and a single declarative merge
spec instead of hand-written per-class load code.
"""

import os
import sys
import uuid
import types
import importlib.util
from dataclasses import dataclass, field, fields

import numpy as np

from tpl_tpu_torch import util


def _uuid():
    return uuid.uuid4().hex


def oriented_box(x, y, yaw, front, back, half_width, closed=False):
    """Corner points of a box spanning [-back, front] x [+-half_width]
    in a body frame posed at (x, y, yaw).  All sim footprints (ego,
    traffic cars, measured hulls) are instances of this one helper."""
    xs = np.array([front, front, -back, -back])
    ys = np.array([-half_width, half_width, half_width, -half_width])
    if closed:
        xs = np.append(xs, xs[0])
        ys = np.append(ys, ys[0])
    c, s = np.cos(yaw), np.sin(yaw)
    return np.stack([x + c * xs - s * ys, y + s * xs + c * ys], axis=1)


@dataclass
class SimIdmParams:
    time_headway: float = 1.5
    gap_min: float = 2.0
    a: float = 1.5
    b: float = 3.0
    delta: float = 4.0


@dataclass
class SimCar:
    uuid: str = field(default_factory=_uuid)
    map_uuid: str = ""

    x: float = 0.0
    y: float = 0.0
    yaw: float = 0.0
    width: float = 2.0
    length: float = 4.0

    proj: object = None
    reverse: bool = False

    v: float = 10.0
    target_v: float = 10.0
    target_change_dt: float = -1.0
    target_last_change_t: float = 0.0
    target_v_low: float = 5.0
    target_v_high: float = 20.0

    use_route_velocity: bool = False
    react_to_curvature: bool = False
    max_lat_acc: float = 2.0

    use_idm: bool = False
    params_idm: SimIdmParams = field(default_factory=SimIdmParams)

    noise_x: float = 0.0
    noise_y: float = 0.0
    noise_yaw: float = 0.0
    noise_v: float = 0.0
    noise_hull: float = 0.0

    evade: str = ""

    @staticmethod
    def get_convex_hull(car):
        # static so it also accepts snapshot/measurement duck-types
        half = car.length / 2.0
        return oriented_box(car.x, car.y, car.yaw,
                            half, half, car.width / 2.0)


@dataclass
class SimEgo:
    x: float = 0.0
    y: float = 0.0
    yaw: float = 0.0

    v: float = 0.0
    a: float = 0.0
    min_v: float = 0.0
    max_v: float = 100.0

    steer_angle: float = 0.0
    max_steer_angle: float = float(np.radians(40.96))

    acc_dead_time: float = 0.0
    steer_dead_time: float = 0.0

    control_acc: float = 0.0
    control_steer: float = 0.0

    width: float = 1.89
    length: float = 5.1

    wheel_base: float = 3.165
    cog_axes_ratio: float = 0.5

    # body overhangs beyond the axles; the pose anchor is the rear axle
    rear_to_rear_axis: float = 2.665 - 3.165 * 0.5
    front_to_front_axis: float = 2.23 - 3.165 * 0.5

    track_width: float = 1.6
    v_ch: float = 32.0

    @staticmethod
    def get_convex_hull(ego):
        return oriented_box(
            ego.x, ego.y, ego.yaw,
            ego.wheel_base + ego.front_to_front_axis,
            ego.rear_to_rear_axis,
            ego.width / 2.0,
            closed=True)


@dataclass
class SimTrafficLight:
    UNKNOWN = -1
    RED = 0
    YELLOW = 1
    GREEN = 2

    uuid: str = field(default_factory=_uuid)
    x: float = 0.0
    y: float = 0.0
    state: int = UNKNOWN


@dataclass
class SimTimeConstraint:
    uuid: str = field(default_factory=_uuid)
    x: float = 0.0
    y: float = 0.0
    t_min: float = 0.0
    t_max: float = 10.0 ** 10


@dataclass
class SimSettings:
    running: bool = False
    reload_requested: bool = True
    single_step_requested: bool = False
    reload_if_finished: bool = False

    use_real_time: bool = True
    fixed_time_step: float = 0.01
    int_step: float = 0.005

    update_logic: bool = True
    update_vehicle_state: bool = True
    update_dynamic_objects: bool = True

    set_env_time: bool = True
    set_env_vehicle_state: bool = True
    set_env_dynamic_objects: bool = True
    set_env_dynamic_objects_dt: float = 0.01
    set_env_traffic_lights: bool = True
    set_env_time_constraints: bool = True


class SimRuleViolation:

    COLLISION = 0
    OFF_ROAD = 1
    WRONG_WAY = 2
    SPEED_LIMIT = 3

    KIND_NAMES = ("COLLISION", "OFF_ROAD", "WRONG_WAY", "SPEED_LIMIT")

    def __init__(self, t, kind, msg=""):
        self.t = t
        self.kind = kind
        self.msg = msg

    def __repr__(self):
        return (f"SimRuleViolation(t={self.t:.2f}, "
                f"{self.KIND_NAMES[self.kind]}, {self.msg})")


@dataclass
class SimRuleChecker:
    enable: bool = False
    off_road_dist_limit: float = 1.0
    v_max_tol: float = 1.0
    violations: list = field(default_factory=list)


@dataclass
class SimState:
    t: float = 0.0
    finished: bool = False

    map_store_path: str = ""
    selected_map: str = ""
    available_maps: list = field(default_factory=list)

    init_env_params: str = ""
    init_planning_params: str = ""
    init_control_params: str = ""

    ego: SimEgo = field(default_factory=SimEgo)
    cars: list = field(default_factory=list)
    traffic_lights: list = field(default_factory=list)
    time_constraints: list = field(default_factory=list)

    rule_checker: SimRuleChecker = field(default_factory=SimRuleChecker)
    settings: SimSettings = field(default_factory=SimSettings)

    manager: object = None


# how scenario-dict keys map onto typed members:
#   key -> (constructor, is_list, keys that are themselves nested specs)
_NESTED = {
    "ego": (SimEgo, False, {}),
    "rule_checker": (SimRuleChecker, False, {}),
    "settings": (SimSettings, False, {}),
    "cars": (SimCar, True, {"params_idm": SimIdmParams}),
    "traffic_lights": (SimTrafficLight, True, {}),
    "time_constraints": (SimTimeConstraint, True, {}),
}

# runtime-only attributes stripped on save, per class
_TRANSIENT = {SimState: ("manager", "available_maps"), SimCar: ("proj",)}


def _from_dict(cls, data, sub_specs=(), into=None):
    obj = into if into is not None else cls()
    if data:
        plain = {k: v for k, v in data.items() if k not in sub_specs}
        util.merge_into(obj, plain)
        for key, sub_cls in dict(sub_specs).items():
            util.merge_into(getattr(obj, key), data.get(key))
    return obj


def _merge_sim(sim, data):
    """Rebuild a SimState from a decoded scenario dict via _NESTED."""
    plain = {k: v for k, v in data.items() if k not in _NESTED}
    util.merge_into(sim, plain)
    for key, (cls, is_list, subs) in _NESTED.items():
        if is_list:
            setattr(sim, key, [_from_dict(cls, item, subs)
                               for item in data.get(key) or []])
        else:
            _from_dict(cls, data.get(key), subs, into=getattr(sim, key))
    return sim


def _to_dict(obj):
    cls = type(obj)
    skip = _TRANSIENT.get(cls, ())
    d = {}
    for k, v in obj.__dict__.items():
        if k in skip:
            continue
        if k in _NESTED and cls is SimState:
            _, is_list, _ = _NESTED[k]
            d[k] = [_to_dict(e) for e in v] if is_list else _to_dict(v)
        elif hasattr(v, "__dict__") and not isinstance(v, np.ndarray):
            d[k] = _to_dict(v)
        else:
            d[k] = v
    return d


def _install_manager_shims():
    """Let scenario manager.py files importing the reference's module
    names resolve against this framework."""
    existing = sys.modules.get("tpl")
    if existing is not None and not getattr(existing, "__tpl_tpu_shim__",
                                            False):
        return

    state_mod = sys.modules[__name__]
    tpl = types.ModuleType("tpl")
    tpl.__tpl_tpu_shim__ = True
    sim_pkg = types.ModuleType("tpl.simulation")
    sim_state = types.ModuleType("tpl.simulation.state")
    for name in ("SimCar", "SimEgo", "SimTrafficLight", "SimTimeConstraint",
                 "SimState", "SimSettings", "SimIdmParams"):
        setattr(sim_state, name, getattr(state_mod, name))
    sim_pkg.state = sim_state
    tpl.simulation = sim_pkg
    sys.modules.setdefault("tpl", tpl)
    sys.modules["tpl.simulation"] = sim_pkg
    sys.modules["tpl.simulation.state"] = sim_state


def save_sim_state(sim, path):
    """Freeze a SimState as a scenario directory (state.json).

    The reference's scenarios are literally frozen SimStates that resume
    mid-scene (reference: state.py:316-337) — saving a running sim
    yields a scenario that restarts exactly there.  ``path`` resolves
    relative to the primary scenarios root unless absolute.  Transient
    fields (manager, car projections, available_maps) are stripped and
    ``finished`` is reset so the frozen scene does not instantly end.
    """
    d = _to_dict(sim)
    d["finished"] = False
    if not os.path.isabs(path):
        path = os.path.join(util.PATH_SCENARIOS, path)
    util.save_state_dict(d, path)
    return path


def load_sim_state(path):
    """Load a scenario directory (state.json + optional manager.py).
    (reference: state.py:329-348)"""
    full = util.resolve_data("scenarios", path)
    data = util.load_state_dict(full)
    if data is None:
        return None

    sim = _merge_sim(SimState(), data)

    manager_path = os.path.join(full, "manager.py")
    if os.path.exists(manager_path):
        _install_manager_shims()
        module_name = ("tpl_tpu_torch_scenario_"
                       + path.replace("/", "_").replace("-", "_"))
        spec = importlib.util.spec_from_file_location(
            module_name, manager_path)
        module = importlib.util.module_from_spec(spec)
        sys.modules[module_name] = module
        spec.loader.exec_module(module)
        sim.manager = module.SimulationManager(sim)

    return sim
