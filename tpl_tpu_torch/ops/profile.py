"""
Velocity-profile helpers.

``rampify_profile`` reproduces the reference's jerk/acceleration-limited
backward+forward spatial velocity integration (reference:
library/tpl/planning/utils.py:6-65). The loops are short (horizon ~250) and
host-side: they take the C route of :mod:`tpl_tpu_torch.native`, with the
plain numpy loops as its oracle; the optimizer consuming the profile runs on
device.
"""

import numpy as np

from tpl_tpu_torch import native


def rampify_profile(v0, a0, lim_v, a_min, a_max, j_min, j_max, v_min, step):
    """Drivable (jerk/acc-limited) velocity profile over space.

    Backward pass limits deceleration into slower regions, forward pass
    limits acceleration out of them. Returns (horizon, 2) array of
    [velocity, acceleration]. v0/a0 may be None to take the backward-pass
    boundary values. (reference: library/tpl/planning/utils.py:6-65)
    """
    if native.enabled():
        return native.rampify_profile(v0, a0, lim_v, a_min, a_max, j_min,
                                      j_max, v_min, step)
    lim_v = np.maximum(np.asarray(lim_v, dtype=np.float64), v_min)
    horizon = len(lim_v)
    profile = np.zeros((horizon, 2))

    # backward pass
    current_v = lim_v[-1]
    current_a = 0.0
    for t in range(horizon - 1, 0, -1):
        profile[t, 0] = current_v
        profile[t, 1] = current_a
        lim_a = max(a_min, (current_v - lim_v[t - 1]) / step * current_v)
        if lim_a < 0.0:
            current_a = max(current_a + j_min / current_v * step, lim_a)
        else:
            current_a = 0.0
            current_v = lim_v[t]
        current_v += min(-current_a / current_v * step, lim_v[t - 1] - current_v)

    # forward pass
    if v0 is None:
        profile[0, 0] = current_v
    else:
        current_v = max(v0, v_min)
        profile[0, 0] = max(v0, v_min)

    if a0 is None:
        current_a = -current_a
        profile[0, 1] = current_a
    else:
        current_a = a0
        profile[0, 1] = a0

    lim_a = 0.0
    for t in range(0, horizon):
        if t < horizon - 1:
            lim_a = min(a_max, (profile[t + 1, 0] - current_v) / step * current_v)
        if lim_a > 0.0:
            current_a = min(current_a + j_max / current_v * step, lim_a)
        else:
            current_a = 0.0
            current_v = profile[t, 0]
        next_v = current_v + min(current_a / current_v * step,
                                 lim_v[t] - current_v)
        current_v = min(profile[t, 0], next_v)
        profile[t, 0] = current_v
        profile[t, 1] = current_a

    return profile


def curv_to_vel_profile(k, lim_v, a_lat_max, k_eps=1e-6):
    """Cap a velocity profile by lateral acceleration over curvature.

    (reference: library/tpl/environment/map_module.py:533-545)
    """
    k = np.abs(np.asarray(k, dtype=np.float64))
    lim_v = np.asarray(lim_v, dtype=np.float64)
    with np.errstate(divide="ignore"):
        v_curv = np.sqrt(a_lat_max / np.maximum(k, 1e-300))
    return np.where(k > k_eps, np.minimum(lim_v, v_curv), lim_v)


def zero_after_first_zero(vel_profile):
    """1.0 until the first falsy entry, 0.0 after.

    (reference: library/tpl/environment/map_module.py:548-557)
    """
    vp = np.asarray(vel_profile, dtype=np.float64)
    nonzero = vp != 0.0
    return np.cumprod(nonzero).astype(np.float64)


def add_vel_constraint(lim_v, index, max_vel=0.0, length=10, shift=0):
    """Clamp lim_v[i:i+length] in place to max_vel.

    (reference: library/tpl/environment/map_module.py:560-570)
    """
    i = int(index + shift)
    l = min(len(lim_v) - i, int(length))
    j = max(0, i + l)
    l = max(0, min(j, l))
    i = max(0, i)
    lim_v[i:j] = np.minimum(lim_v[i:j], max_vel)
