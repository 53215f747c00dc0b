"""
tpl_tpu_torch — the PyTorch / CUDA port of ``tpl_tpu``.

The ported path is the closed loop through ``simulation.SimStandalone``
with the vendored param sets' own planner and controller, the RSTP
(path / velocity decomposed) planner and the tracking MPC, or with any of
the other ported planners and controllers selected by name: ``ops`` (host
geometry, profiles, LQR, splines, the solver's table lookups),
``environment``, ``application`` (environment, planning and control apps),
``planning`` (trajectory, replan policy; the RSTP planner with its fused
replan step; the DP lat/lon planner; the FAS-2025 chain,
``poly_lat_dp_lon_planner`` and ``lattice_planner``; the rollout planners,
``idm_sampling_planner`` and ``poly_sampling_planner``; the graph DP
planner, ``dp_poly_planner``), ``optim`` (the AL-iLQR core, its problems,
the ``Solver`` and the batched update), ``control`` (the spatial and the
time-indexed tracking MPC, the feedforward, flat and direct controllers and
the constant-deceleration fallback), ``native`` (the host C routes),
``util`` (stores, param sets, live code reloading) and ``simulation`` (the
standalone loop, the recorder and replay, and the ``tplsim`` command line:
``python -m tpl_tpu_torch.simulation.tplsim run --headless``).  Twelve
hand-written Hopper kernel sources live under ``csrc/``:
``ilqr_tracking_mpc.cu`` (the float64 tracking-MPC solve, single and
batched), ``ilqr_tracking_mpc_time.cu`` (the float64 time-indexed
tracking-MPC solve), ``ilqr_rstp.cu`` (the float32 RSTP profile solves),
``rstp_rampify.cu`` (the RSTP rampify scan and the FAS start mode),
``latlon_action_min.cu`` (the DP backward action-min and fused slice),
``lon_dp.cu`` and ``poly_lat.cu`` (the FAS chain's lon DP and lateral
sweep), ``idm_rollout.cu`` and ``idm_evaluate.cu`` (the IDM sampling
rollouts and their screens, sharing ``idm_common.cuh``) and
``poly_sampling.cu`` (the Werling grid), ``dir_dist_map.cu`` and
``poly_planner.cu`` (the graph DP planner's directional distance field, its
edge evaluation and its cost propagation);
``csrc/latency_probe.cu`` measures the card's operation latencies for
their bounds.

The device is the card unless the caller asks otherwise: :func:`device`
resolves an unset device to ``cuda`` through :func:`use_device`, which
raises where there is no card.  ``use_device("cpu")`` is the only way to
the CPU (the tests use it); nothing moves to the CPU because no GPU was
found.
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
    """The device chosen by :func:`use_device`; ``cuda`` if none was
    chosen (raises where there is no card)."""
    if _DEVICE is None:
        return use_device("cuda")
    return _DEVICE
