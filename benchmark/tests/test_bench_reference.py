"""The frozen reference agrees with the port's plain CPU solves of both
problems at a small batch and horizon: ``tpl_tpu_torch``'s plain batched
update for the tracking MPC (a shared course), its ``Solver`` (the plain
iLQR on the CPU) for the smoother (a road a scenario).  The test imports
both; the reference itself imports nothing of the port."""

import torch

from benchmark import common
from benchmark.tests.bench_small import small_cell

TOL = 1e-12


def rel(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1.0)


def test_tracking_mpc_against_the_ports_plain_batch():
    from tpl_tpu_torch.optim import batched, problems

    cell = small_cell("tracking_mpc.fleet")
    cfg = cell.config
    H, B = cfg["horizon"], 6
    scen = cell.module("scenarios").make(cfg, cell.traffic, 77, B,
                                         torch.device("cpu"))
    ref = cell.module("reference").solve(cfg, scen, torch.arange(B),
                                         torch.float64)
    prob, _ = problems.trajectory_tracking_mpc(ref_capacity=128)
    update = batched.make_batched_update_fn(prob, H, B, 1, torch.float64)
    params = {k: torch.tensor(v, dtype=torch.float64)
              for k, v in scen["scalars"].items()}
    params.update(scen["tables"])
    last = lambda a: a.movedim(0, -1).contiguous()
    xs, u, lam, mu, costs, its = update.reference(
        torch.zeros(H + 1, 7, B), last(scen["u"]), last(scen["lam"]),
        scen["mu_step"], last(scen["x0"]), params,
        common.limits(cfg, "cpu", torch.float64), iterations=True)
    assert rel(xs.movedim(-1, 0), ref["x"]) < TOL
    assert rel(u.movedim(-1, 0), ref["u"]) < TOL
    assert rel(lam.movedim(-1, 0), ref["lam"]) < TOL
    assert rel(costs, ref["traj_costs"]) < TOL
    assert torch.equal(mu.to(torch.int64), ref["mu_step"])
    assert torch.equal(its, ref["iterations"])
    assert int(ref["iterations"].max()) > 1


def test_smoother_against_the_ports_plain_solver():
    """The smoother's yardstick, kept for its cell of the open questions
    (no cell of ``BENCHMARK.json`` uses it yet), on its tick inputs at a
    horizon of 40."""
    import json
    import os

    from benchmark import harness
    from benchmark.entries.solo import Entry
    from benchmark.reference import ref_line_smoother as reference
    from benchmark.scenarios import ref_line_smoother as scenarios

    with open(os.path.join(harness.BENCH_DIR, "configs",
                           "ref_line_smoother.json")) as f:
        cfg = json.load(f)
    cfg["horizon"] = 40
    traffic = dict(entry="solo", pool=3, inputs="tick")
    scen = scenarios.make(cfg, traffic, 78, 3, torch.device("cpu"))
    entry = Entry(cfg, traffic, scen, torch.device("cpu"), torch.float64)
    for i in range(3):
        entry.keep(i, entry.call(i))
    got = entry.results()
    ref = reference.solve(cfg, scen, got["scenarios"], torch.float64)
    for name in ("x", "u", "traj_costs"):
        assert rel(got[name], ref[name]) < TOL, name
    assert torch.equal(got["mu_step"], ref["mu_step"])
