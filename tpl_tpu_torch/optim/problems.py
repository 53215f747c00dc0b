"""
The framework's solver configurations, as torch problem definitions.

The port of ``tpl_tpu/optim/problems.py`` (which re-expresses the
reference's sympy optimizer configs, library/tpl/optim/optimizers.py).
``torch.func`` differentiates them; ``.detach()`` replaces genopt's
``fixed()``.  Every function broadcasts over leading dimensions of ``x``,
``u`` and ``t`` (see :mod:`tpl_tpu_torch.optim.ilqr`).

Each factory returns ``(Problem, param_spec)`` where param_spec maps param
names to either a float default (scalar) or an :class:`ArraySpec` (fixed
capacity, edge-padded on assignment so the clamped lerp semantics match the
reference's variable-length arrays exactly).
"""

import torch

from tpl_tpu_torch.optim.ilqr import Problem
from tpl_tpu_torch.ops.interp import lerp, lerp_angle, box_interp, lerp_multi


class ArraySpec:
    """Fixed-capacity 1-D array parameter."""

    def __init__(self, capacity, default=0.0):
        self.capacity = capacity
        self.default = default


def trajectory_tracking_mpc(ref_capacity=128):
    """Spatial-progress trajectory tracking MPC.

    States [x, y, phi, delta, v, s_r, a], actions [jerk, delta_dot];
    kinematic bicycle with characteristic velocity; reference course lerp'd
    over arc-length progress s_r carried as a state.
    (reference: optimizers.py:12-126)
    """

    def refs(p, s_r):
        mat = torch.stack([p["ref_x"], p["ref_y"], p["ref_k"], p["ref_v"]],
                          dim=1)
        vals = lerp_multi(0.0, p["ref_step"], s_r, mat)
        r_phi = lerp_angle(0.0, p["ref_step"], s_r, p["ref_phi"])
        return vals[..., 0], vals[..., 1], r_phi, vals[..., 2], vals[..., 3]

    def core(x, u, p):
        px, py, phi, delta, v, s_r, a = x.unbind(-1)
        r_x, r_y, r_phi, r_k, r_v = refs(p, s_r)
        # equivalent to lerp(..., fixed(s_r), ref_v): the value is identical
        # and the gradient through s_r is blocked either way
        v_trg = r_v.detach()
        phi_dot = v / (p["l"] * (1 + (v / p["v_ch"]) ** 2)) * torch.tan(delta)
        d_r = torch.cos(r_phi) * (py - r_y) - torch.sin(r_phi) * (px - r_x)
        s_dot = v * torch.cos(phi - r_phi) / (1 - d_r * r_k)
        return phi_dot, d_r, s_dot, v_trg, r_phi, r_k

    def dynamics(x, u, t, dt, p):
        px, py, phi, delta, v, s_r, a = x.unbind(-1)
        j, delta_dot = u.unbind(-1)
        phi_dot, d_r, s_dot, _, _, _ = core(x, u, p)
        return torch.stack([
            v * torch.cos(phi),
            v * torch.sin(phi),
            phi_dot,
            delta_dot,
            a + p["a_offset"],
            s_dot,
            j,
        ], dim=-1)

    def cost(x, u, t, dt, p):
        px, py, phi, delta, v, s_r, a = x.unbind(-1)
        j, delta_dot = u.unbind(-1)
        phi_dot, d_r, s_dot, v_trg, r_phi, r_k = core(x, u, p)
        c = (p["min_pdelta_dot"] + p["pdelta_dot"] * v ** 2) * delta_dot ** 2
        c = c + (p["min_p_phi_dot"] + p["p_phi_dot"] * v ** 2) * phi_dot ** 2
        c = c + p["pa"] * a ** 2
        c = c + p["pj"] * j ** 2
        c = c + p["pv"] * (v - v_trg) ** 2
        c = c + p["pd"] * d_r ** 2
        c = c + p["p_phi"] * (1.0 - torch.cos(phi - r_phi))
        c = c + (p["p_phi_ref_dot_diff"] * (phi_dot - s_dot * r_k) ** 2
                 * v ** 2)
        return c

    def constraints(x, u, t, dt, p):
        delta = x[..., 3]
        a = x[..., 6]
        return torch.stack([
            delta - p["max_delta"],
            -p["max_delta"] - delta,
            a - p["max_acc"],
            p["min_acc"] - a,
        ], dim=-1)

    prob = Problem("trajectory_tracking_mpc", nx=7, nu=2, nc=4,
                   dynamics=dynamics, cost=cost, end_cost=None,
                   constraints=constraints,
                   kernel="trajectory_tracking_mpc")
    spec = dict(
        pd=0.0, pv=0.0, pdelta=0.0, min_pdelta_dot=0.0, pdelta_dot=0.0,
        min_p_phi_dot=0.0, p_phi_dot=0.0, p_phi=0.0, p_phi_ref_dot_diff=0.0,
        pa=0.0, pj=0.0, l=1.0, v_ch=32.0,
        ref_x=ArraySpec(ref_capacity), ref_y=ArraySpec(ref_capacity),
        ref_phi=ArraySpec(ref_capacity), ref_k=ArraySpec(ref_capacity),
        ref_v=ArraySpec(ref_capacity), ref_step=0.5,
        max_delta=0.7, max_acc=3.0, min_acc=-3.0, a_offset=0.0)
    return prob, spec


def trajectory_tracking_mpc_time(ref_capacity=128):
    """Time-indexed tracking MPC with CoG slip angle.
    (reference: optimizers.py:129-240)
    """

    def refs(p, rt):
        mat = torch.stack([p["ref_x"], p["ref_y"], p["ref_v"]], dim=1)
        vals = lerp_multi(0.0, p["ref_dt"], rt, mat)
        r_phi = lerp_angle(0.0, p["ref_dt"], rt, p["ref_phi"])
        return vals[..., 0], vals[..., 1], r_phi, vals[..., 2]

    def dynamics(x, u, t, dt, p):
        px, py, phi, delta, v, a = x.unbind(-1)
        j, delta_dot = u.unbind(-1)
        beta = torch.atan(torch.tan(delta) * p["cog_pos"])
        phi_dot = (v * torch.tan(delta) * torch.cos(beta)
                   / (p["l"] * (1 + (v / p["v_ch"]) ** 2)))
        return torch.stack([
            v * torch.cos(phi + beta),
            v * torch.sin(phi + beta),
            phi_dot,
            delta_dot,
            a + p["a_offset"],
            j,
        ], dim=-1)

    def cost(x, u, t, dt, p):
        px, py, phi, delta, v, a = x.unbind(-1)
        j, delta_dot = u.unbind(-1)
        rt = p["ref_t_offset"] + dt * t
        r_x, r_y, r_phi, v_trg = refs(p, rt)
        beta = torch.atan(torch.tan(delta) * p["cog_pos"])
        phi_dot = (v * torch.tan(delta) * torch.cos(beta)
                   / (p["l"] * (1 + (v / p["v_ch"]) ** 2)))
        c = (p["min_pdelta_dot"] + p["pdelta_dot"] * v ** 2) * delta_dot ** 2
        c = c + (p["min_p_phi_dot"] + p["p_phi_dot"] * v ** 2) * phi_dot ** 2
        c = c + p["pa"] * a ** 2
        c = c + p["pj"] * j ** 2
        c = c + p["pv"] * (v - v_trg) ** 2
        c = c + p["pd"] * (px - r_x) ** 2 + p["pd"] * (py - r_y) ** 2
        c = c + p["p_phi"] * (1.0 - torch.cos(phi - r_phi))
        return c

    def constraints(x, u, t, dt, p):
        delta = x[..., 3]
        a = x[..., 5]
        return torch.stack([
            delta - p["max_delta"],
            -p["max_delta"] - delta,
            a - p["max_acc"],
            p["min_acc"] - a,
        ], dim=-1)

    prob = Problem("trajectory_tracking_mpc_time", nx=6, nu=2, nc=4,
                   dynamics=dynamics, cost=cost, end_cost=None,
                   constraints=constraints,
                   kernel="trajectory_tracking_mpc_time")
    spec = dict(
        pd=0.0, pv=0.0, pdelta=0.0, min_pdelta_dot=0.0, pdelta_dot=0.0,
        min_p_phi_dot=0.0, p_phi_dot=0.0, p_phi=0.0,
        pa=0.0, pj=0.0, l=1.0, v_ch=32.0, cog_pos=0.5,
        ref_x=ArraySpec(ref_capacity), ref_y=ArraySpec(ref_capacity),
        ref_phi=ArraySpec(ref_capacity), ref_v=ArraySpec(ref_capacity),
        ref_dt=0.1, ref_t_offset=0.0,
        max_delta=0.7, max_acc=3.0, min_acc=-3.0, a_offset=0.0)
    return prob, spec


def lateral_profile(ref_capacity=256):
    """Corridor-constrained lateral offset profile over arc length.

    States [d, v_d] (offset and its spatial derivative), action [a_d];
    cartesian curvature reconstructed from Frenet quantities as the comfort
    cost. (reference: optimizers.py:243-294)
    """

    def lookups(p, s):
        mat = torch.stack([p["k_ref"], p["d_offset"], p["d_lower_constr"],
                           p["d_upper_constr"]], dim=1)
        vals = lerp_multi(0.0, p["ref_step"], s, mat)
        return vals[..., 0], vals[..., 1], vals[..., 2], vals[..., 3]

    def dynamics(x, u, t, dt, p):
        return torch.stack([x[..., 1], u[..., 0]], dim=-1)

    def cost(x, u, t, dt, p):
        d, v_d = x.unbind(-1)
        a_d = u[..., 0]
        s = t * dt
        k_r, d_o, _, _ = lookups(p, s)
        k = ((a_d / (v_d ** 2 + 1) + k_r) * torch.cos(torch.atan(v_d))
             / (1 - d * k_r))
        return (p["w_d"] * (d - d_o) ** 2 + p["w_v_d"] * v_d ** 2
                + p["w_a_d"] * a_d ** 2 + p["w_k"] * k ** 2)

    def end_cost(x, t, dt, p):
        d, v_d = x.unbind(-1)
        s = t * dt
        d_o = lerp(0.0, p["ref_step"], s, p["d_offset"])
        return p["w_d"] * (d - d_o) ** 2 + p["w_v_d"] * v_d ** 2

    def constraints(x, u, t, dt, p):
        d = x[..., 0]
        s = t * dt
        _, _, d_lower, d_upper = lookups(p, s)
        return torch.stack([d_lower - d, d - d_upper], dim=-1)

    prob = Problem("lateral_profile", nx=2, nu=1, nc=2,
                   dynamics=dynamics, cost=cost, end_cost=end_cost,
                   constraints=constraints,
                   kernel="lateral_profile")
    spec = dict(
        k_ref=ArraySpec(ref_capacity), d_offset=ArraySpec(ref_capacity),
        d_lower_constr=ArraySpec(ref_capacity),
        d_upper_constr=ArraySpec(ref_capacity),
        ref_step=0.5, w_d=0.5, w_v_d=0.5, w_a_d=0.5, w_k=0.5)
    return prob, spec


def velocity_profile_space(ref_capacity=256):
    """Velocity/time profile over arc length.

    States [v, st] with spatial dynamics dv/ds = a/v, dt/ds = 1/v
    (regularized below v = 1), total-acceleration ellipse, velocity and
    min/max crossing-time constraints. (reference: optimizers.py:352-428)
    """

    def dynamics(x, u, t, dt, p):
        v, st = x.unbind(-1)
        a = u[..., 0]
        t_offset = box_interp(p["ref_step"], t * dt, p["ref_t_offset"])
        fast = v > 1.0 + 1e-3
        # divide by v only where it is taken: autograd sends the zero
        # gradient of the branch not taken through 1 / v, and at v = 0 its
        # infinite slope turns that zero into NaN (JAX's where selects the
        # derivative instead)
        v_fast = torch.where(fast, v, torch.ones_like(v))
        dv = torch.where(fast, a / v_fast, a)
        dst = torch.where(fast, 1.0 / v_fast, t_offset)
        return torch.stack(torch.broadcast_tensors(dv, dst), dim=-1)

    def cost(x, u, t, dt, p):
        v, st = x.unbind(-1)
        a = u[..., 0]
        s = t * dt
        mat = torch.stack([p["ref_v"], p["ref_v_weight"]], dim=1)
        vals = lerp_multi(0.0, p["ref_step"], s, mat)
        v_trg, v_weight = vals[..., 0], vals[..., 1]
        return p["p_v"] * (v_trg - v) ** 2 * v_weight + p["p_a"] * a ** 2

    def constraints(x, u, t, dt, p):
        v, st = x.unbind(-1)
        a = u[..., 0]
        s = t * dt
        mat = torch.stack([p["ref_v"], p["ref_t_min"], p["ref_t_max"]],
                          dim=1)
        vals = lerp_multi(0.0, p["ref_step"], s, mat)
        v_trg, t_min, t_max = vals[..., 0], vals[..., 1], vals[..., 2]
        kk = box_interp(p["ref_step"], s, p["ref_k"])
        t_offset = box_interp(p["ref_step"], s, p["ref_t_offset"])

        a_lat = v ** 2 * kk
        constr_a_max = (a ** 2 + a_lat ** 2) - p["max_a_total"] ** 2
        constr_v_min = 1.0 - v
        constr_v_max = v - v_trg
        constr_t_max = (st + t_offset) - t_max
        constr_t_min = (t_min - st) * torch.where(t_min > 0.0, v - 1.0, 1.0)
        return torch.stack([constr_a_max, constr_v_min, constr_v_max,
                            constr_t_max, constr_t_min], dim=-1)

    prob = Problem("velocity_profile_space", nx=2, nu=1, nc=5,
                   dynamics=dynamics, cost=cost, end_cost=None,
                   constraints=constraints,
                   kernel="velocity_profile_space")
    spec = dict(
        p_v=0.1, p_a=1.0, max_a_total=5.0,
        ref_v=ArraySpec(ref_capacity), ref_k=ArraySpec(ref_capacity),
        ref_step=0.5,
        ref_t_max=ArraySpec(ref_capacity, default=1e10),
        ref_t_min=ArraySpec(ref_capacity),
        ref_t_offset=ArraySpec(ref_capacity, default=1.0),
        ref_v_weight=ArraySpec(ref_capacity, default=1.0))
    return prob, spec


def velocity_profile_time(ref_capacity=256):
    """Time-indexed velocity profile with spatio-temporal corridor.

    States [s, v], action [a]; constraints: v bounds, s within
    [s_min(t), s_max(t)] windows gated on positivity.
    (reference: optimizers.py:297-349; defined upstream but not in its
    build list.)
    """

    def dynamics(x, u, t, dt, p):
        return torch.stack([x[..., 1], u[..., 0]], dim=-1)

    def cost(x, u, t, dt, p):
        v = x[..., 1]
        return p["w_v"] * (1000.0 - v) + p["w_a"] * u[..., 0] ** 2

    def constraints(x, u, t, dt, p):
        s, v = x.unbind(-1)
        v_max = lerp(0.0, p["ref_step"], s, p["ref_v"])
        s_max = box_interp(1.0, t, p["ref_s_max"])
        s_min = box_interp(1.0, t, p["ref_s_min"])
        zero = torch.zeros_like(s)
        return torch.stack(torch.broadcast_tensors(
            0.0 - v,
            v - v_max,
            torch.where(s_max > 0, s - s_max, zero),
            torch.where(s_min > 0, s_min - s, zero),
        ), dim=-1)

    prob = Problem("velocity_profile_time", nx=2, nu=1, nc=4,
                   dynamics=dynamics, cost=cost, end_cost=None,
                   constraints=constraints,
                   kernel="velocity_profile_time")
    spec = dict(w_v=1.0, w_a=1.0, ref_v=ArraySpec(ref_capacity),
                ref_step=0.5, ref_s_max=ArraySpec(ref_capacity),
                ref_s_min=ArraySpec(ref_capacity))
    return prob, spec


def ref_line_smoother_k(ref_capacity=512):
    """Reference-line smoothing with curvature as the action.
    (reference: optimizers.py:431-490)
    """

    def dynamics(x, u, t, dt, p):
        return torch.stack([torch.cos(x[..., 2]), torch.sin(x[..., 2]),
                            u[..., 0]], dim=-1)

    def cost(x, u, t, dt, p):
        s = t * dt
        x_ref = lerp(0.0, p["ref_step"], s, p["ref_x"])
        y_ref = lerp(0.0, p["ref_step"], s, p["ref_y"])
        return (p["w_pos"] * (x[..., 0] - x_ref) ** 2
                + p["w_pos"] * (x[..., 1] - y_ref) ** 2
                + p["w_k"] * u[..., 0] ** 2)

    prob = Problem("ref_line_smoother_k", nx=3, nu=1, nc=0,
                   dynamics=dynamics, cost=cost,
                   kernel="ref_line_smoother_k")
    spec = dict(w_pos=1.0, w_k=0.1,
                ref_x=ArraySpec(ref_capacity), ref_y=ArraySpec(ref_capacity),
                ref_step=0.5)
    return prob, spec


def ref_line_smoother_dk(ref_capacity=512):
    """Reference-line smoothing with curvature rate as the action.
    (reference: optimizers.py:493-557)
    """

    def dynamics(x, u, t, dt, p):
        return torch.stack([torch.cos(x[..., 2]), torch.sin(x[..., 2]),
                            x[..., 3], u[..., 0]], dim=-1)

    def cost(x, u, t, dt, p):
        s = p["s_start"] + t * dt
        x_ref = lerp(0.0, p["ref_step"], s, p["ref_x"])
        y_ref = lerp(0.0, p["ref_step"], s, p["ref_y"])
        return (p["w_pos"] * (x[..., 0] - x_ref) ** 2
                + p["w_pos"] * (x[..., 1] - y_ref) ** 2
                + p["w_k"] * x[..., 3] ** 2
                + p["w_dk"] * u[..., 0] ** 2)

    prob = Problem("ref_line_smoother_dk", nx=4, nu=1, nc=0,
                   dynamics=dynamics, cost=cost,
                   kernel="ref_line_smoother_dk")
    spec = dict(w_pos=1.0, w_k=0.1, w_dk=0.1, s_start=0.0,
                ref_x=ArraySpec(ref_capacity), ref_y=ArraySpec(ref_capacity),
                ref_step=0.5)
    return prob, spec
