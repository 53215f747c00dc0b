"""Trajectories solved by every update the window completed, over the
window's seconds (its start to the end of its last update)."""


def read(run):
    return run["solves"] / run["window_s"] if run["walls"] else None
