"""The window's seconds over the solves it completed, in ms."""


def read(run):
    return run["window_s"] / run["solves"] * 1e3 if run["walls"] else None
