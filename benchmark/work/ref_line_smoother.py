"""
The work one solve of ``ref_line_smoother`` needs: operations from the
steps of the algorithm and the bytes of its inputs read once and its result
written once.  A frozen copy of the port's counts for the generic kernel
(``tpl_tpu_torch/optim/ilqr_generic.py``: ``NATIVE``'s counts of
``ref_line_smoother_k``, ``step_ops``, ``operations``,
``traffic_bytes``), with the line search's candidates counted as those the
scenario rolls rather than all eight.

One evaluation (an add, multiply, divide, compare, lookup step or
transcendental counts as one; a lookup is 6): the dynamics 2, the cost
2 x 6 + 11 = 23, no constraints.
"""

NX, NU, NC, NCL = 3, 1, 0, 1
DYNAMICS, COST, CONSTRAINTS = 2, 2 * 6 + 1 + 10, 0
N_SCALARS, N_TABLES, N_ALPHAS = 3, 2, 8


def step_ops(cfg):
    nx, nu, nc = NX, NU, NC
    nv = nx + nu
    stages = {"EULER": 1, "HEUN": 2, "RK4": 4}[cfg["integrator"]]
    dyn = stages * DYNAMICS + 2 * nx * stages + nx
    step_cost = COST + CONSTRAINTS + 5 * nc
    solve_ops = nx + 4                                      # nu = 1
    riccati = (2 * nx * nx + 2 * nu * nx + 4 * nx ** 3 + nx * nx
               + 2 * nu * nx * nx + 2 * nu * nu * nx + nu * nu
               + 2 * nu * nx * nx + nu * nx + solve_ops + 4 * nu
               + 2 * nx * nu * nu + 6 * nu * nx * nx + 3 * nx * nx
               + 6 * nu * nx + 3 * nx)
    return dict(open_rollout_step=dyn, rollout_step=dyn + nu * (2 * nx + 4),
                step_cost=step_cost, riccati_step=riccati,
                derivatives=(DYNAMICS + step_cost + nv + nv * (nv + 1) // 2
                             + nx * nv),
                multipliers=CONSTRAINTS + 4 * NCL)


def solve_ops(cfg, iterations, rolled):
    """Operations of one scenario's update that ran ``iterations`` iLQR
    iterations and rolled ``rolled`` line-search candidates in all."""
    o = step_ops(cfg)
    n = cfg["horizon"]
    init = n * (o["open_rollout_step"] + o["step_cost"] + 1)
    per_it = n * (o["derivatives"] + o["riccati_step"])
    per_candidate = n * (o["rollout_step"] + o["step_cost"] + 1)
    return (init + cfg["max_lg_iterations"] * n * o["multipliers"]
            + iterations * per_it + rolled * per_candidate)


def operations(cfg, ref):
    """Operations of each scenario the reference solved (``ref``, with
    its ``iterations`` and ``rolled`` candidates), in its order."""
    return [solve_ops(cfg, i, r) for i, r in
            zip(ref["iterations"].tolist(), ref["rolled"].tolist())]


def reals(cfg, batch):
    """Reals one call must move: the shared part (limits, settings, step
    sizes, tables) once, each scenario's row (start, controls, multipliers,
    scalars, mu_step) and result once."""
    H, n_ref = cfg["horizon"], cfg["ref_capacity"]
    shared = H * NU * 2 + NCL * 2 + 2 + N_ALPHAS + N_TABLES * n_ref
    row = NX + H * NU + H * NCL + N_SCALARS + 1
    out = (H + 1) * NX + H * NU + H * NCL + 3
    return shared + (1 if batch is None else batch) * (row + out)
