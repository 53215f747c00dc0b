"""
The solo entry: one vehicle's solve through
``tpl_tpu_torch.optim.solver.Solver``, in a closed loop.

Call i loads the pool's entry i mod pool into one ``Solver`` (its tables
where each scenario has its own, then ``load_state`` with the start and
the warm start), calls ``update()`` and reads the result back on the host
as the vehicle's caller does: the first action (the controller's
``u[0]``), or the smoothed path (``PathSmoothing.update``: the poses from
the states, the curvature from the controls).  ``update()`` ends with its
download, so the call ends with the result on the host.  Each entry's
result of one seeded round is copied for the check.
"""

import numpy as np
import torch

from benchmark import common


class Entry:
    batch = None        # one solve a call

    def __init__(self, cfg, traffic, scen, device, dtype):
        from tpl_tpu_torch.optim import problems
        from tpl_tpu_torch.optim.solver import Solver

        self.cfg, self.device = cfg, device
        H, nx = cfg["horizon"], cfg["nx"]
        self.P = traffic["pool"]
        prob, spec = getattr(problems, cfg["problem"])(
            ref_capacity=cfg["ref_capacity"])
        opt = Solver(prob, spec, horizon_max=H, dtype=dtype, device=device)
        opt.integrator_type = common.INTEGRATORS[cfg["integrator"]]
        opt.horizon = H
        opt.step = cfg["step"]
        opt.max_iterations = cfg["max_iterations"]
        opt.max_lg_iterations = cfg["max_lg_iterations"]
        opt.min_rel_cost_change = cfg["min_rel_cost_change"]
        opt.u_min[:] = cfg["u_min"]
        opt.u_max[:] = cfg["u_max"]
        opt.barrier_weight[:] = cfg["barrier_weight"]
        opt.lg_mult_limit = cfg["lg_mult_limit"]
        for name, v in scen["scalars"].items():
            setattr(opt.params, name, v)
        self.opt = opt

        host = lambda a: a[:self.P].cpu().numpy()
        self.own_tables = {}
        for name, v in scen["tables"].items():
            if v.dim() == 1:
                setattr(opt.params, name, v.cpu().numpy())
            else:
                self.own_tables[name] = host(v)
        x0 = host(scen["x0"])
        self.x = np.zeros((self.P, H + 1, nx))
        self.x[:, 0] = x0
        self.u, self.lam = host(scen["u"]), host(scen["lam"])
        self.mu_step = host(scen["mu_step"])
        self.kept = {}

    def call(self, i):
        k, opt = i % self.P, self.opt
        for name, tab in self.own_tables.items():
            setattr(opt.params, name, tab[k])
        opt.load_state(self.x[k], self.u[k], self.lam[k], self.mu_step[k])
        opt.update()
        if self.cfg["readback"] == "first_action":
            return opt.u[0].copy()
        path = np.zeros((opt.horizon, 6))
        path[:, :3] = opt.x[:-1, :3]
        path[:, 4] = opt.u[:, 0]
        return path

    def keep(self, k, out):
        """Copies the solver's result of the call on pool entry ``k``."""
        opt = self.opt
        self.kept[k] = (opt.x.copy(), opt.u.copy(),
                        opt.lagrange_multiplier.copy(), opt._mu_step,
                        opt.traj_costs)

    def results(self):
        """The kept results, scenario first, on the device as float64: a
        dict of ``x``, ``u``, ``lam``, ``mu_step``, ``traj_costs`` and the
        ``scenarios`` they belong to."""
        ks = sorted(self.kept)
        cols = list(zip(*(self.kept[k] for k in ks)))
        f64 = lambda a: torch.as_tensor(np.stack(a), dtype=torch.float64,
                                        device=self.device)
        return dict(x=f64(cols[0]), u=f64(cols[1]), lam=f64(cols[2]),
                    mu_step=torch.as_tensor(cols[3], dtype=torch.int64,
                                            device=self.device),
                    traj_costs=f64(cols[4]),
                    scenarios=torch.as_tensor(ks, device=self.device))

    def close(self):
        self.kept.clear()
        self.opt = None
