"""The 95th percentile (nearest rank) of every solve of the window, each
from setting one vehicle's inputs to its result on the host, in ms."""

from benchmark.harness import p95


def read(run):
    return p95(run["walls"]) * 1e3 if run["walls"] else None
