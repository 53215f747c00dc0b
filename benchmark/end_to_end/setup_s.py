"""Process start to the first timed call: imports, the CUDA context, the
kernels' libraries (built in the checkout's ``build/`` at the first run),
the inputs made from the seed (for a tick, with the reference's solves
of the ticks before it), and the warm-up calls."""


def read(run):
    return run["setup_s"]
