"""
The fleet entry: ``tpl_tpu_torch.optim.batched``'s update, one batch of
scenarios a call, in a closed loop.

Call i solves the pool's batch i mod pool, each a batch of ``batch``
seeded scenarios that share the configuration's tables; the call ends in a
synchronize.  The outputs of one seeded round of each pool batch are kept
(the returned tensors themselves, no copy) for the check.
"""

import torch

from benchmark import common


class Entry:
    def __init__(self, cfg, traffic, scen, device, dtype):
        from tpl_tpu_torch.optim import batched, problems

        self.cfg, self.device, self.dtype = cfg, device, dtype
        B, P, H = traffic["batch"], traffic["pool"], cfg["horizon"]
        self.batch, self.P = B, P
        prob, _ = getattr(problems, cfg["problem"])(
            ref_capacity=cfg["ref_capacity"])
        self.update = batched.make_batched_update_fn(
            prob, H, B, common.INTEGRATORS[cfg["integrator"]], dtype)
        t = lambda a: a.to(device=device, dtype=dtype)
        self.params = {k: torch.tensor(v, dtype=dtype, device=device)
                       for k, v in scen["scalars"].items()}
        self.params.update({k: t(v) for k, v in scen["tables"].items()})
        self.limits = common.limits(cfg, device, dtype)
        self.pool = []
        for k in range(P):
            rows = slice(k * B, (k + 1) * B)
            last = lambda a: t(a[rows]).movedim(0, -1).contiguous()
            x = torch.zeros((H + 1, cfg["nx"], B), dtype=dtype,
                            device=device)
            self.pool.append((x, last(scen["u"]), last(scen["lam"]),
                              scen["mu_step"][rows].contiguous(),
                              last(scen["x0"])))
        self.kept = {}

    def call(self, i):
        out = self.update(*self.pool[i % self.P], self.params, self.limits)
        common.synchronize(self.device)
        return out

    def keep(self, k, out):
        """Keeps ``out``, the result of a call on pool entry ``k``."""
        self.kept[k] = out

    def results(self):
        """The kept outputs, scenario first in the order of the pool's
        scenarios, as float64: a dict of ``x``, ``u``, ``lam``,
        ``mu_step``, ``traj_costs`` and the ``scenarios`` they belong to."""
        parts = {n: [] for n in common.OUTPUTS}
        scenarios = []
        for k in sorted(self.kept):
            xs, u, lam, mu, costs = self.kept[k]
            for name, a in zip(common.OUTPUTS, (xs, u, lam, mu, costs)):
                parts[name].append(a.movedim(-1, 0) if a.dim() > 1 else a)
            scenarios.append(torch.arange(k * self.batch, (k + 1) * self.batch,
                                          device=self.device))
        out = {n: torch.cat(v) for n, v in parts.items()}
        out = {n: (v.to(torch.int64) if n == "mu_step"
                   else v.to(torch.float64)) for n, v in out.items()}
        out["scenarios"] = torch.cat(scenarios)
        return out

    def close(self):
        self.kept.clear()
        self.pool.clear()
        self.update = None
