"""The check fails what it must: a run with the timed path broken
underneath (the harness's look for a chip skipped, the rest of the run as
it is) reads ``correct`` false for each fault a cell can have, and so does
each cell's control (its configuration's lower precision, at a size a test
run holds); the sound program reads true."""

import pytest
import torch

from benchmark.tests.bench_small import run_small

CELLS = ("tracking_mpc.fleet", "tracking_mpc.solo")


def broken_batch(monkeypatch, fault):
    from tpl_tpu_torch.optim import batched

    make = batched.make_batched_update_fn

    def make_broken(*args, **kwargs):
        update = make(*args, **kwargs)

        def broken(x, u, lam, mu_step, x0, params, cfg):
            out = list(update(x, u, lam, mu_step, x0, params, cfg))
            if fault == "unchanged":
                out[:4] = [x.clone(), u.clone(), lam.clone(),
                           mu_step.clone()]
            elif fault == "half":
                h = x.shape[-1] // 2
                for j, a in enumerate((x, u, lam, mu_step)):
                    out[j] = out[j].clone()
                    out[j][..., h:] = a[..., h:]
            else:
                out[1] = out[1].clone()
                out[1][0, 0, 0] += 0.01
            return tuple(out)

        return broken

    monkeypatch.setattr(batched, "make_batched_update_fn", make_broken)


def broken_solver(monkeypatch, fault):
    from tpl_tpu_torch.optim.solver import Solver

    update = Solver.update

    def broken(self):
        if fault == "unchanged":
            self.updates += 1
            return self
        update(self)
        self._u[0, 0] += 0.01
        return self

    monkeypatch.setattr(Solver, "update", broken)


@pytest.mark.parametrize("name", CELLS)
def test_the_sound_program_is_correct(name):
    res, numbers = run_small(name)
    assert res["correct"] is True, numbers


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_fleet_faults_read_incorrect(monkeypatch, fault):
    broken_batch(monkeypatch, fault)
    res, numbers = run_small("tracking_mpc.fleet")
    assert res["correct"] is False, (fault, numbers)


@pytest.mark.parametrize("name", CELLS[1:])
@pytest.mark.parametrize("fault", ["unchanged", "altered"])
def test_solo_faults_read_incorrect(monkeypatch, name, fault):
    broken_solver(monkeypatch, fault)
    res, numbers = run_small(name)
    assert res["correct"] is False, (fault, numbers)


@pytest.mark.parametrize("name", CELLS)
def test_the_control_reads_incorrect(name):
    res, numbers = run_small(name, variant="control")
    assert res["correct"] is False, numbers


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_a_short_run_on_the_card_is_correct(cuda_device, name):
    import subprocess
    import sys
    import json
    import os

    from benchmark import harness

    done = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", name, "--seed",
         "2147483711", "--seconds", "2", "--trace", "0"],
        cwd=harness.REPO, capture_output=True, text=True, timeout=1200,
        env=dict(os.environ))
    assert done.returncode == 0, done.stderr[-3000:]
    res = json.loads(done.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
    assert torch.cuda.get_device_name(cuda_device) == res["device"]["kind"]
