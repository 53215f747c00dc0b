"""A rank of the two-process ``torch.distributed`` check of
``tests/test_torch_parallel.py`` (started with
``torch.multiprocessing.spawn``; imports only torch and the port)."""

import json
import os

import torch


def best_candidate_rank(rank, init_file, out_dir, world):
    """Join the gloo group by ``file://`` init, solve a toy batch whose
    costs differ per rank over a two-entry CPU mesh, and write this rank's
    local and global minima to ``out_dir/rank<rank>.json``."""
    import tpl_tpu_torch
    from tpl_tpu_torch.parallel import (init_distributed, scenario_mesh,
                                        sharded_best_candidate)

    tpl_tpu_torch.use_device("cpu")
    assert init_distributed("file://" + init_file, world, rank)
    try:
        mesh = scenario_mesh(2)

        def batched_solve(x0):
            return x0 * 2.0, (x0[:, 0] - 3.0) ** 2

        x0 = torch.arange(8.0).reshape(8, 1) + 10.0 * (1 - rank)
        out, costs, best = sharded_best_candidate(batched_solve, mesh)(x0)
        res = dict(local=float(costs.min()), best=float(best),
                   backend=torch.distributed.get_backend(),
                   doubled=bool(torch.equal(out, x0 * 2.0)))
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        torch.distributed.destroy_process_group()
