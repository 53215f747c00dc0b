"""
What the harness's parts share: the integrators by name, the outputs a
solve is judged by, the limits of a configuration as tensors, and the
synchronize that ends a call on the card.
"""

import torch

INTEGRATORS = {"EULER": 0, "HEUN": 1, "RK4": 2}
OUTPUTS = ("x", "u", "lam", "mu_step", "traj_costs")
DTYPES = {"float64": torch.float64, "float32": torch.float32}


def limits(cfg, device, dtype):
    """The limits and settings of ``cfg`` in the layout of the batched
    update's ``cfg`` (and of the reference's): ``u_min`` / ``u_max``
    (H, nu), ``barrier_weight`` / ``lg_mult_limit`` (nc,), ``dt``,
    ``min_rel_cost_change``, ``T``, ``max_iterations``,
    ``max_lg_iterations``."""
    H, ncl = cfg["horizon"], max(cfg["nc"], 1)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return dict(u_min=t(cfg["u_min"]).expand(H, cfg["nu"]).contiguous(),
                u_max=t(cfg["u_max"]).expand(H, cfg["nu"]).contiguous(),
                barrier_weight=t([cfg["barrier_weight"]] * ncl),
                lg_mult_limit=t([cfg["lg_mult_limit"]] * ncl),
                dt=t(cfg["step"]),
                min_rel_cost_change=t(cfg["min_rel_cost_change"]), T=H,
                max_iterations=cfg["max_iterations"],
                max_lg_iterations=cfg["max_lg_iterations"])


def synchronize(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
