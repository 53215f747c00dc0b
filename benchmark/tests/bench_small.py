"""Small cells for the CPU tests: the benchmark's cells with their pools,
batches and horizons cut so that a test run holds them."""

import time

from benchmark import harness

SMALL = {"tracking_mpc.fleet": dict(batch=4, pool=2, kept_round_max=2),
         "tracking_mpc.solo": dict(pool=3)}
HORIZON = {"tracking_mpc": 20}
# the controls at their configurations' horizons, with enough scenarios
# that the lower precision's gaps show as they do at the cells' sizes
CONTROL = {"tracking_mpc.fleet": dict(batch=64, pool=2, kept_round_max=2),
           "tracking_mpc.solo": dict(pool=64)}


def small_cell(name, horizon=True, sizes=SMALL):
    cell = harness.Cell(harness.load_spec(), name)
    cell.traffic.update(sizes[name])
    if horizon:
        cell.config["horizon"] = HORIZON[cell.config_name]
    return cell


def run_small(name, seed=20240611, trace=False, variant="program"):
    control = variant == "control"
    cell = small_cell(name, horizon=not control,
                      sizes=CONTROL if control else SMALL)
    return harness.run_cell(cell, seed, 0.05, trace, "cpu",
                            time.perf_counter(), variant)
