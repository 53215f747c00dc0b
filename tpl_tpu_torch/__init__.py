"""
tpl_tpu_torch — the PyTorch / CUDA port of ``tpl_tpu``.

The ported path is the closed loop through ``simulation.SimStandalone``
with the DP lat/lon planner and the tracking MPC: ``ops`` (host geometry,
profiles, LQR, the solver's table lookups), ``environment``,
``application`` (environment, planning and control apps), ``planning``
(trajectory, replan policy, the DP environment, the lat/lon
value-iteration solve), ``optim`` (the AL-iLQR core, its problems and the
``Solver``), ``control`` (the tracking MPC and the constant-deceleration
fallback) and ``simulation``.  Two hand-written Hopper kernels live under
``csrc/``: the DP backward action-min and the float64 tracking-MPC solve.

The device is always explicit: call :func:`use_device` once before any
solve; :func:`device` raises if that never happened.  Nothing picks a
device by itself and nothing moves to the CPU because no GPU was found.
"""

__version__ = "0.1.0"

_DEVICE = None


def use_device(name):
    """Select the torch device every solve runs on ("cuda", "cuda:1",
    "cpu")."""
    import torch

    global _DEVICE
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r} requested but CUDA is not "
                           "available")
    _DEVICE = dev
    return dev


def device():
    """The device chosen by :func:`use_device`."""
    if _DEVICE is None:
        raise RuntimeError("no device selected: call "
                           "tpl_tpu_torch.use_device(...) first")
    return _DEVICE
