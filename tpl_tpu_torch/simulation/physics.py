"""
Simulation physics as pure, array-first building blocks: an actuator
delay line, the kinematic-bicycle ego step, a vectorized IDM longitudinal
model, traffic agents riding map paths, batched measurement noise, and a
batched rule checker.

Behavioral parity target: the reference's SimCore physics
(library/tpl/simulation/core.py:91-386) — identical models and
thresholds, restructured around this framework's batched-geometry ops
(`project_many`, `intersect_polygons_batch`).
"""

import numpy as np

from tpl_tpu_torch import util
from tpl_tpu_torch.ops import intersect_polygons_batch
from tpl_tpu_torch.simulation.state import SimCar, SimEgo, SimRuleViolation


class DelayLine:
    """Actuator dead-time: replay the command issued ``dead_time`` ago.

    Commands are appended per step as (stamp, value); sampling returns
    the oldest command still inside the dead-time window, or the latest
    when the dead time is zero.
    """

    def __init__(self):
        self.stamps = []
        self.values = []

    def clear(self):
        self.stamps = []
        self.values = []

    def push(self, t, value, dead_time, dt):
        self.stamps.append(t)
        self.values.append(value)
        cap = int(dead_time // dt) + 1
        if len(self.stamps) > cap:
            del self.stamps[:len(self.stamps) - cap]
            del self.values[:len(self.values) - cap]

    def sample(self, t, dead_time, default):
        if not self.stamps:
            return default
        if dead_time == 0.0:
            return self.values[-1]
        for stamp, value in zip(self.stamps, self.values):
            if t - stamp <= dead_time:
                return value
        return default


def step_bicycle(ego, dt):
    """Kinematic bicycle with characteristic-velocity understeer term.

    Mutates ego in place; ``ego.a``/``ego.steer_angle`` must already hold
    the delayed actuator commands.
    """
    understeer = 1.0 + (ego.v / ego.v_ch) ** 2
    ego.x += dt * ego.v * np.cos(ego.yaw)
    ego.y += dt * ego.v * np.sin(ego.yaw)
    ego.yaw = util.normalize_angle(
        ego.yaw + dt * ego.v * np.tan(ego.steer_angle)
        / (ego.wheel_base * understeer))
    ego.v = np.clip(ego.v + dt * ego.a, ego.min_v, ego.max_v)
    ego.steer_angle = np.clip(
        ego.steer_angle, -ego.max_steer_angle, ego.max_steer_angle)


def idm_acceleration(v, v_lead, gap, target_v, p):
    """Intelligent-Driver-Model acceleration (vectorized over agents)."""
    v = np.asarray(v, dtype=float)
    desired_gap = (p.gap_min + v * p.time_headway
                   + v * (v - v_lead) / (2.0 * np.sqrt(p.a * p.b)))
    acc = p.a * (1.0 - (v / np.maximum(0.001, target_v)) ** p.delta
                 - (desired_gap / gap) ** 2)
    return np.clip(acc, -p.b, p.a)


def _lookahead_path(cmap, car):
    """Forward path window the car scans for a leader."""
    steps = int(np.clip(abs(car.v) * 4 / cmap.step_size_discr, 50, 200))
    if car.reverse:
        return util.path_segment(cmap.path, -steps, car.proj.end,
                                 cmap.closed_path)
    return util.path_segment(cmap.path, steps, car.proj.start,
                             cmap.closed_path)


def _leader_gap(car, cmap, agents_xy, ego_v, ego_yaw):
    """Net gap and leader speed ahead of ``car`` along its map path.

    All other agents (ego first, then every other car) are projected
    onto the car's lookahead window in one batched call; candidates are
    the in-bounds projections within half a lane of the path.
    """
    window = _lookahead_path(cmap, car)
    s_self = util.project(window[:, :2], (car.x, car.y)).arc_len + car.length

    pr = util.project_many(window[:, :2], agents_xy)
    near = pr["in_bounds"] & (np.abs(pr["distance"]) < car.width)
    if not near.any():
        return 1e6, 0.0
    cand = np.flatnonzero(near)
    lead = cand[np.argmin(pr["arc_len"][cand])]
    gap = pr["arc_len"][lead] - s_self
    # parity quirk: traffic always reads the leader's speed off the ego's
    # motion state, even when the leader is another car
    # (reference core.py:177-179)
    v_lead = ego_v * np.cos(pr["angle"][lead] - ego_yaw)
    return gap, v_lead


def snap_to_path(car, cmap):
    """(Re)project a drifted car onto its map path and align its pose."""
    pos = np.array([car.x, car.y])
    stale = (car.proj is None
             or np.linalg.norm(pos - car.proj.point) > 0.0
             or abs(np.cos(car.yaw - car.proj.angle)) > 0.5)
    if stale:
        car.proj = util.project(cmap.path[:, :2], pos, cmap.closed_path)
        if car.reverse:
            car.proj.angle = util.normalize_angle(car.proj.angle + np.pi)
        car.x, car.y = car.proj.point
        car.yaw = car.proj.angle


def step_traffic(t, ego, cars, maps, dt):
    """Advance all traffic agents one step.

    Longitudinal control is IDM against the nearest leader (ego
    included); lateral motion is a hard path-following constraint
    (re-projection after integration).
    """
    by_map = util.get_obj_dict(maps)
    # shared agent table: ego center first, then every car
    ego_xy = (ego.x + np.cos(ego.yaw) * ego.wheel_base * 0.5,
              ego.y + np.sin(ego.yaw) * ego.wheel_base * 0.5)

    for car in cars:
        cmap = by_map.get(car.map_uuid)
        if cmap is None:
            continue
        snap_to_path(car, cmap)

        if car.use_idm:
            others = np.array(
                [ego_xy] + [(o.x, o.y) for o in cars if o is not car])
            gap, v_lead = _leader_gap(car, cmap, others, ego.v, ego.yaw)
            acc = idm_acceleration(car.v, v_lead, gap, car.target_v,
                                   car.params_idm)
            car.v += dt * acc
            if car.v < 0.001 and acc <= 0.0:
                car.v = 0.0
        else:
            car.v = car.target_v

        # integrate along the tangent, then re-anchor on the path
        car.x += dt * car.v * np.cos(car.yaw)
        car.y += dt * car.v * np.sin(car.yaw)
        car.proj = util.project(cmap.path[:, :2], np.array([car.x, car.y]))
        if car.reverse:
            car.proj.angle = util.normalize_angle(car.proj.angle + np.pi)
        car.yaw = car.proj.angle

        _retarget_velocity(car, cmap.path, t)


def _retarget_velocity(car, path, t):
    """Post-step target-speed shaping: random retargeting, route speed,
    curvature-limited lateral acceleration."""
    if car.target_change_dt > 0.0 \
            and t - car.target_last_change_t > car.target_change_dt:
        car.target_v = np.random.uniform(car.target_v_low, car.target_v_high)
        car.target_last_change_t = t

    if car.use_route_velocity:
        car.target_v = path[min(car.proj.index, len(path) - 1), 5]

    if car.react_to_curvature:
        curvature = abs(path[car.proj.start, 4])
        if curvature > 1e-5:
            car.v = min(np.sqrt(car.max_lat_acc / curvature), car.v)


def noisy_car_measurements(env_t, cars):
    """Batched noisy observations of all traffic cars.

    Draws all pose/velocity noise in four vectorized calls and returns
    a list of perturbed car snapshots (hull noise stays per-car since
    hull vertex counts vary).
    """
    n = len(cars)
    sig = np.array([[c.noise_x, c.noise_y, c.noise_yaw, c.noise_v]
                    for c in cars], dtype=float).reshape(n, 4)
    noise = np.zeros((n, 4))
    for k in range(4):
        live = sig[:, k] > 0.0
        if live.any():
            noise[live, k] = np.random.normal(0.0, sig[live, k])

    out = []
    for i, car in enumerate(cars):
        meas = util.snapshot(car)
        meas.x += noise[i, 0]
        meas.y += noise[i, 1]
        meas.yaw += noise[i, 2]
        meas.v += noise[i, 3]
        out.append(meas)
    return out


def check_rules(sim, cmap):
    """Batched rule checker: collision / off-road / wrong-way / speed.

    All car-hull collision tests run as one SAT program
    (`intersect_polygons_batch`); the road-relative checks share a
    single ego projection.
    """
    rc = sim.rule_checker
    if not rc.enable:
        return

    if sim.cars:
        hulls = [SimCar.get_convex_hull(c) for c in sim.cars]
        k_max = max(len(h) for h in hulls)
        padded = np.stack([
            np.vstack([h, np.repeat(h[-1:], k_max - len(h), axis=0)])
            for h in hulls])
        hit = intersect_polygons_batch(padded, SimEgo.get_convex_hull(sim.ego))
        for i in np.flatnonzero(hit):
            rc.violations.append(SimRuleViolation(
                sim.t, SimRuleViolation.COLLISION,
                f"ego collides with {sim.cars[i].uuid}"))

    if cmap is None:
        return

    proj = util.project(cmap.path[:, :2], np.array([sim.ego.x, sim.ego.y]))
    bound_r = -cmap.d_right[proj.index]
    bound_l = cmap.d_left[proj.index]
    if proj.distance < 0.0 and proj.distance + bound_r > 0.0:
        rc.violations.append(SimRuleViolation(
            sim.t, SimRuleViolation.OFF_ROAD,
            f"d_ego: {proj.distance} < d_right: {bound_r}"))
    if proj.distance > 0.0 and proj.distance - bound_l > 0.0:
        rc.violations.append(SimRuleViolation(
            sim.t, SimRuleViolation.OFF_ROAD,
            f"d_ego: {proj.distance} > d_left: {bound_l}"))

    if np.cos(proj.angle - sim.ego.yaw) < 0.0:
        rc.violations.append(SimRuleViolation(
            sim.t, SimRuleViolation.WRONG_WAY,
            f"yaw_ego: {sim.ego.yaw} not aligned with "
            f"yaw_path: {proj.angle}"))

    v_limit = cmap.path[proj.index, 5]
    if sim.ego.v > v_limit + rc.v_max_tol:
        rc.violations.append(SimRuleViolation(
            sim.t, SimRuleViolation.SPEED_LIMIT,
            f"v_ego: {sim.ego.v} > v_max: {v_limit}"))
