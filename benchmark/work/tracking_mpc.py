"""
The work one solve of ``tracking_mpc`` needs: operations from the steps of
the algorithm and the bytes of its inputs read once and its result written
once.  A frozen copy of the port's counts
(``tpl_tpu_torch/optim/ilqr_tracking_mpc.py``: ``OPS``,
``operations``, ``traffic_bytes``, ``traffic_bytes_batched``), which count
what the algorithm needs whatever implements it.

Operations of one step (an add, multiply, divide, compare or
transcendental counts as one): the dynamics with their table lookups 58,
the augmented step cost 119, one closed-loop HEUN rollout step 203, one
Riccati step 2,520, the derivatives of one step (one pass over the step
cost, 119, and one operation for each entry of the block that is neither
structurally zero nor a constant: gradient 9, Hessian 25, Jacobian 11) and
the multiplier update 20.
"""

OPS = dict(dynamics=58, step_cost=119, rollout_step=203, riccati_step=2520,
           derivatives=119 + 9 + 25 + 11, multipliers=20)
NX, NU, NC = 7, 2, 4
N_SCALARS, N_TABLES, N_ALPHAS = 18, 5, 8


def solve_ops(cfg, iterations, rolled):
    """Operations of one scenario's update that ran ``iterations`` iLQR
    iterations and rolled ``rolled`` line-search candidates in all."""
    n = cfg["horizon"]
    open_loop = 2 * OPS["dynamics"] + 35        # no feedback, no clamp
    init = n * (open_loop + OPS["step_cost"] + 1)
    per_it = n * (OPS["derivatives"] + OPS["riccati_step"])
    per_candidate = n * (OPS["rollout_step"] + OPS["step_cost"] + 1)
    return (init + cfg["max_lg_iterations"] * n * OPS["multipliers"]
            + iterations * per_it + rolled * per_candidate)


def operations(cfg, ref):
    """Operations of each scenario the reference solved (``ref``, with
    its ``iterations`` and ``rolled`` candidates), in its order."""
    return [solve_ops(cfg, i, r) for i, r in
            zip(ref["iterations"].tolist(), ref["rolled"].tolist())]


def reals(cfg, batch):
    """Reals one call must move: a single solve's packed input (x, u, lam,
    limits, settings, step sizes, scalars, tables) and result; a batch's
    shared part once and each scenario's row and result once."""
    H, n_ref = cfg["horizon"], cfg["ref_capacity"]
    out = (H + 1) * NX + H * NU + H * NC + 3
    if batch is None:
        inp = ((H + 1) * NX + H * NU + H * NC + H * NU * 2 + NC * 2 + 2
               + N_ALPHAS + N_SCALARS + N_TABLES * n_ref)
        return inp + out
    shared = H * NU * 2 + NC * 2 + 2 + N_ALPHAS + N_TABLES * n_ref
    row = NX + H * NU + H * NC + N_SCALARS
    return shared + batch * (row + out)
