"""The 95th percentile (nearest rank) of every update of the window, each
from the call to the synchronize after it, in ms."""

from benchmark.harness import p95


def read(run):
    return p95(run["walls"]) * 1e3 if run["walls"] else None
