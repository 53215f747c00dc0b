"""
The seeded scenarios of ``ref_line_smoother``: one road a vehicle, a
clothoid-like raw line (curvature linear between knots, each knot uniform
within the limit) with seeded lateral noise on its points, drawn on the
device from the seed (the configuration's ``assumed``), of the one kind
of ``inputs`` it has, ``tick``: the replan in RSTP's closed loop.  Each
vehicle drives its road at a seeded speed.  The first replan starts cold
from the raw line, as ``PathSmoothing``'s reset does; the reference solves
the configuration's ``solved_ticks`` replans one after another, each warm
from the one before shifted by the samples the window's start slid since,
as ``PathSmoothing.update`` shifts it (``Solver.shift``), and the scenario
is the next replan.
"""

import math

import torch

from benchmark.reference import ref_line_smoother


def make(cfg, traffic, seed, n, device):
    """``n`` scenarios of ``cfg`` from ``seed`` on ``device`` (float64):
    a dict of ``x0`` (n, 3), ``u`` (n, H, 1), ``lam`` (n, H, 1),
    ``mu_step`` (n,) int32, ``scalars`` and the ``tables`` ``ref_x``,
    ``ref_y`` (n, samples), one road window a scenario."""
    a = cfg["assumed"]
    road, replan = a["road"], a["replan"]
    if traffic["inputs"] != "tick":
        raise ValueError(f"ref_line_smoother has no inputs "
                         f"{traffic['inputs']!r}")
    ticks = replan["solved_ticks"]
    f64 = dict(dtype=torch.float64, device=device)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    H, m, ds = cfg["horizon"], road["samples"], road["spacing_m"]
    v_lo, v_hi = replan["speed_m_per_s"]
    most = math.ceil(v_hi * replan["period_s"] / ds)
    total = m + ticks * most

    per_knot = int(round(road["knot_spacing_m"] / ds))
    n_knots = (total - 1) // per_knot + 2
    knots = road["k_max_per_m"] * (
        2.0 * torch.rand((n, n_knots), generator=g, **f64) - 1.0)
    i = torch.arange(total, device=device)
    lo, frac = i // per_knot, (i % per_knot).to(torch.float64) / per_knot
    k = knots[:, lo] * (1.0 - frac) + knots[:, lo + 1] * frac
    phi0 = math.pi * (2.0 * torch.rand((n, 1), generator=g, **f64) - 1.0)
    # the heading and the points by the trapezoid rule along the arc
    step = lambda f: torch.cat([torch.zeros((n, 1), **f64), torch.cumsum(
        0.5 * ds * (f[:, 1:] + f[:, :-1]), 1)], 1)
    phi = phi0 + step(k)
    px, py = step(torch.cos(phi)), step(torch.sin(phi))
    noise = road["lateral_noise_m"] * torch.randn((n, total), generator=g,
                                                  **f64)
    raw_x = px - torch.sin(phi) * noise
    raw_y = py + torch.cos(phi) * noise
    v = v_lo + (v_hi - v_lo) * torch.rand(n, generator=g, **f64)
    phase = torch.rand(n, generator=g, **f64)

    rows = torch.arange(n, device=device)
    window = lambda a, start, count: torch.gather(
        a, 1, start[:, None] + torch.arange(count, device=device)[None])
    start = torch.zeros(n, dtype=torch.int64, device=device)
    scen = dict(x0=torch.stack([raw_x[:, 0], raw_y[:, 0], phi[:, 0]], 1),
                u=k[:, :H, None].clone(), lam=torch.zeros((n, H, 1), **f64),
                mu_step=torch.zeros(n, dtype=torch.int32, device=device),
                scalars=dict(cfg["scalars"]),
                tables=dict(ref_x=raw_x[:, :m], ref_y=raw_y[:, :m]))
    # the window's start in samples after j replans
    at = lambda j: torch.floor(phase + j * v * replan["period_s"] / ds).to(
        torch.int64)
    for j in range(ticks):
        prev = ref_line_smoother.solve(cfg, scen, rows, torch.float64)
        slid = at(j + 1) - at(j)
        start = start + slid
        idx_u = torch.clamp(torch.arange(H, device=device)[None]
                            + slid[:, None], max=H - 1)[..., None]
        scen = dict(scen, x0=prev["x"][rows, torch.clamp(slid, max=H)],
                    u=torch.gather(prev["u"], 1, idx_u),
                    lam=torch.gather(prev["lam"], 1, idx_u),
                    mu_step=prev["mu_step"].to(torch.int32),
                    tables=dict(ref_x=window(raw_x, start, m),
                                ref_y=window(raw_y, start, m)))
    return scen
