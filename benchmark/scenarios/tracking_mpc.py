"""
The seeded scenarios of ``tracking_mpc`` on the shared course of the JAX
bench's ``_mpc_setup`` (a sine of 2 m amplitude at 8 m/s, 128 samples at
0.5 m), drawn on the device from the seed (the configuration's
``assumed``), of the kind the mix's ``inputs`` names:

- ``spread``: each scenario a start spread about the course and seeded
  warm controls and mu steps, as a Monte-Carlo sweep of the controller
  sends them;
- ``tick``: the controller's tick in its closed loop.  Each vehicle starts
  on the course at a seeded station, off it by what a state estimate
  errs; the reference solves its first tick from zero controls at the
  configuration's settings, the vehicle moves one control cycle under the
  first action, and the scenario is the next tick: that start, warm from
  the solution before, unshifted, as ``ModelPredictiveController`` keeps
  it (its step of 0.05 s spans five cycles of 0.01 s).
"""

import torch

from benchmark import common
from benchmark.reference import ilqr, tracking_mpc
from benchmark.reference.interp import lerp, lerp_angle


def gradient(f, h):
    """numpy's ``gradient`` of samples spaced ``h``: central differences
    inside, one-sided at the two ends."""
    inner = (f[2:] - f[:-2]) / (2.0 * h)
    return torch.cat([(f[1:2] - f[:1]) / h, inner, (f[-1:] - f[-2:-1]) / h])


def course_tables(course, device):
    f64 = dict(dtype=torch.float64, device=device)
    ss = torch.arange(course["samples"], **f64) * course["spacing_m"]
    ref_y = course["y_amplitude_m"] * torch.sin(
        ss * course["y_wavenumber_per_m"])
    ref_phi = torch.atan(gradient(ref_y, course["spacing_m"]))
    ref_k = gradient(ref_phi, course["spacing_m"])
    return dict(ref_x=ss, ref_y=ref_y, ref_phi=ref_phi, ref_k=ref_k,
                ref_v=torch.full_like(ss, course["speed_m_per_s"]))


def make(cfg, traffic, seed, n, device):
    """``n`` scenarios of ``cfg`` from ``seed`` on ``device`` (float64):
    a dict of ``x0`` (n, nx), ``u`` (n, H, nu), ``lam`` (n, H, nc),
    ``mu_step`` (n,) int32, ``scalars`` and the shared ``tables``."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    tables = course_tables(cfg["assumed"]["course"], device)
    kind = traffic["inputs"]
    if kind == "spread":
        return spread(cfg, g, n, tables)
    if kind == "tick":
        return tick(cfg, g, n, tables)
    raise ValueError(f"tracking_mpc has no inputs {kind!r}")


def spread(cfg, g, n, tables):
    a = cfg["assumed"]
    start, warm = a["start"], a["warm_start"]
    device = tables["ref_x"].device
    f64 = dict(dtype=torch.float64, device=device)
    H, nx, nu, nc = cfg["horizon"], cfg["nx"], cfg["nu"], cfg["nc"]
    b = torch.arange(n, device=device) % start["ramp_period"]
    x0 = (torch.tensor(start["base"], **f64)[None]
          + start["ramp"] * b[:, None].to(torch.float64)
          + start["sigma"] * torch.tensor(start["scale"], **f64)[None]
          * torch.randn((n, nx), generator=g, **f64))
    u = warm["u_sigma"] * torch.randn((n, H, nu), generator=g, **f64)
    lam = torch.full((n, H, max(nc, 1)), warm["lam"], **f64)
    mu_step = torch.randint(0, warm["mu_step_max"] + 1, (n,), generator=g,
                            device=device).to(torch.int32)
    return dict(x0=x0, u=u, lam=lam, mu_step=mu_step,
                scalars=dict(cfg["scalars"]), tables=tables)


def tick(cfg, g, n, tables):
    t = cfg["assumed"]["tick"]
    sc = cfg["scalars"]
    device = tables["ref_x"].device
    f64 = dict(dtype=torch.float64, device=device)
    H, nu, nc = cfg["horizon"], cfg["nu"], cfg["nc"]
    lo, hi = t["station_m"]
    s0 = lo + (hi - lo) * torch.rand(n, generator=g, **f64)
    err = torch.randn((3, n), generator=g, **f64)
    d = t["sigma"]["lateral_m"] * err[0]
    v = t["speed_m_per_s"] + t["sigma"]["speed_m_per_s"] * err[2]
    look = lambda name: lerp(0.0, sc["ref_step"], s0, tables[name])
    r_phi = lerp_angle(0.0, sc["ref_step"], s0, tables["ref_phi"])
    # the steering angle that holds the course's curvature at speed v
    delta = torch.atan(look("ref_k") * sc["l"] * (1 + (v / sc["v_ch"]) ** 2))
    x0 = torch.stack([look("ref_x") - torch.sin(r_phi) * d,
                      look("ref_y") + torch.cos(r_phi) * d,
                      r_phi + t["sigma"]["heading_rad"] * err[1], delta, v,
                      s0, torch.zeros(n, **f64)], 1)
    scen = dict(x0=x0, u=torch.zeros((n, H, nu), **f64),
                lam=torch.zeros((n, H, max(nc, 1)), **f64),
                mu_step=torch.zeros(n, dtype=torch.int32, device=device),
                scalars=dict(sc), tables=tables)
    p = {k: torch.tensor(val, **f64) for k, val in sc.items()}
    p.update(tables)
    rows = torch.arange(n, device=device)
    for _ in range(t["solved_ticks"]):
        prev = tracking_mpc.solve(cfg, scen, rows, torch.float64)
        x1 = ilqr.integrate(tracking_mpc.PROBLEM, scen["x0"],
                            prev["u"][:, 0], 0,
                            torch.tensor(t["cycle_s"], **f64), p,
                            common.INTEGRATORS[cfg["integrator"]])
        scen = dict(scen, x0=x1, u=prev["u"], lam=prev["lam"],
                    mu_step=prev["mu_step"].to(torch.int32))
    return scen
