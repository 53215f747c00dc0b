"""
The host C++ routes of the port: ``hostops.cpp`` and ``shmstore.cpp``, each
built with ``g++`` at first use (:func:`tpl_tpu_torch._build.load_host`,
keyed by the source's hash, into ``build/tpl_tpu_torch/``) and bound with
``ctypes``.

The port of ``tpl_tpu/native/__init__.py``.  ``shmstore.cpp`` is the native
engine of the shared-memory stores (:mod:`tpl_tpu_torch.util.shm_store`):
:func:`get_shm_lib` binds it, :class:`NativeShm` is one store's mapping.
Four sequential host routines have a C twin: polyline projection and
resampling (:mod:`tpl_tpu_torch.ops.geometry`), the jerk-limited velocity
profile (:mod:`tpl_tpu_torch.ops.profile`) and the corridor ramp
(:mod:`tpl_tpu_torch.planning.path_vel_decomp.path_optim`).  Each of those
functions asks :func:`enabled` and takes the C route, counted in ``calls``;
its numpy body stays as the oracle and runs only after ``enable(False)``.
There is no quiet fallback: a missing ``g++`` or a failed compile raises
with the compiler's output.
"""

import ctypes
import os

import numpy as np

from tpl_tpu_torch import _build

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "hostops.cpp")
SHM_SOURCE = os.path.join(_HERE, "shmstore.cpp")
SHM_FLAGS = ["-O2", "-shared", "-fPIC", "-pthread"]
ROUTES = ("project", "resample", "rampify_profile", "rampify_corridor")

calls = dict.fromkeys(ROUTES, 0)    # C calls per route (reset freely)

_enabled = True
_lib = None
_shm_lib = None


def enable(on=True):
    """Switch the four hooks between the C routes (the default) and their
    numpy oracles; returns the previous setting."""
    global _enabled
    was, _enabled = _enabled, bool(on)
    return was


def enabled():
    return _enabled


def get_lib():
    """Build (first call) and bind ``hostops.cpp``; raises if that fails."""
    global _lib
    if _lib is None:
        lib = _build.load_host(SOURCE)
        dp, i64, i32, dbl = (ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
                             ctypes.c_int32, ctypes.c_double)
        lib.tpl_resample.restype = i64
        lib.tpl_resample.argtypes = [dp, i64, dbl, i64, i64, i32, dp]
        lib.tpl_rampify_profile.restype = None
        lib.tpl_rampify_profile.argtypes = ([dbl, dbl, i32, i32, dp, i64]
                                            + [dbl] * 6 + [dp])
        lib.tpl_project.restype = None
        lib.tpl_project.argtypes = [dp, i64, dp, i64, i32, dp]
        lib.tpl_rampify_corridor.restype = None
        lib.tpl_rampify_corridor.argtypes = [dbl, i64, dbl, dbl, dp, i64, dbl,
                                             dp, dp, dp]
        _lib = lib
    return _lib


def _ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _f64(a):
    return np.ascontiguousarray(a, dtype=np.float64)


def resample(points, sampling_dist, steps, start_index=0, closed=False):
    """C twin of ``ops.geometry.resample``: (steps, 5) rows [x, y, alpha,
    prev_idx, next_idx]."""
    lib = get_lib()
    pts = _f64(points[:, :2])
    out = np.zeros((steps, 5))
    if steps == 0 or len(pts) == 0:
        return out[:0]
    calls["resample"] += 1
    res = lib.tpl_resample(_ptr(pts), len(pts), float(sampling_dist),
                           int(steps), int(start_index), int(bool(closed)),
                           _ptr(out))
    if res < 0:
        raise RuntimeError("resampling failed")
    return out[:res] if res < steps else out


def project(points, positions, closed=False):
    """C twin of ``ops.geometry._project_core`` for a polyline of at least
    two vertices: an (M, 12) array with columns [start, end, alpha, index,
    point_x, point_y, distance, arc_len, angle, tangent_x, tangent_y,
    in_bounds]."""
    lib = get_lib()
    pts = _f64(points[:, :2])
    if len(pts) < 2:
        raise ValueError("project needs a polyline of at least two vertices")
    pos = _f64(positions).reshape(-1, 2)
    out = np.zeros((len(pos), 12))
    calls["project"] += 1
    lib.tpl_project(_ptr(pts), len(pts), _ptr(pos), len(pos),
                    int(bool(closed)), _ptr(out))
    return out


def rampify_profile(v0, a0, lim_v, a_min, a_max, j_min, j_max, v_min, step):
    """C twin of ``ops.profile.rampify_profile``: (horizon, 2) rows
    [velocity, acceleration]; ``v0`` / ``a0`` may be None."""
    lib = get_lib()
    lim = _f64(lim_v)
    if lim.ndim != 1 or len(lim) == 0:
        raise ValueError("rampify_profile needs a non-empty 1-D limit")
    out = np.zeros((len(lim), 2))
    calls["rampify_profile"] += 1
    lib.tpl_rampify_profile(
        float(v0 if v0 is not None else 0.0),
        float(a0 if a0 is not None else 0.0),
        int(v0 is not None), int(a0 is not None), _ptr(lim), len(lim),
        float(a_min), float(a_max), float(j_min), float(j_max), float(v_min),
        float(step), _ptr(out))
    return out


def rampify_corridor(step, horizon, sharpness, proj_distance, path, gap,
                     lower, upper):
    """C twin of ``path_optim.rampify_corridor``: the (len(path),) lower
    bound profile."""
    lib = get_lib()
    path_v = _f64(path[:, 5])
    lo, up = _f64(lower), _f64(upper)
    n, horizon = len(path_v), int(horizon)
    if not 0 < horizon <= min(n, len(lo), len(up)):
        raise ValueError(f"horizon {horizon} outside the path ({n}) or the "
                         f"bounds ({len(lo)}, {len(up)})")
    out = np.zeros(n)
    calls["rampify_corridor"] += 1
    lib.tpl_rampify_corridor(float(step), horizon, float(sharpness),
                             float(proj_distance), _ptr(path_v), n,
                             float(gap), _ptr(lo), _ptr(up), _ptr(out))
    return out


def get_shm_lib():
    """Build (first call) and bind ``shmstore.cpp``; raises if that fails."""
    global _shm_lib
    if _shm_lib is None:
        lib = _build.load_host(SHM_SOURCE, SHM_FLAGS)
        vp, i64, u64 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint64
        lib.tpl_shm_open.restype = vp
        lib.tpl_shm_open.argtypes = [ctypes.c_char_p, i64,
                                     ctypes.POINTER(ctypes.c_int)]
        for name in ("tpl_shm_lock", "tpl_shm_unlock"):
            getattr(lib, name).restype = ctypes.c_int
            getattr(lib, name).argtypes = [vp]
        lib.tpl_shm_version.restype = u64
        lib.tpl_shm_version.argtypes = [vp]
        lib.tpl_shm_capacity.restype = i64
        lib.tpl_shm_capacity.argtypes = [vp]
        lib.tpl_shm_read.restype = i64
        lib.tpl_shm_read.argtypes = [vp, ctypes.c_char_p, i64,
                                     ctypes.POINTER(u64)]
        lib.tpl_shm_write.restype = u64
        lib.tpl_shm_write.argtypes = [vp, ctypes.c_char_p, i64]
        lib.tpl_shm_close.restype = None
        lib.tpl_shm_close.argtypes = [vp]
        _shm_lib = lib
    return _shm_lib


class NativeShm:
    """One store's mapping in the native engine (``shmstore.cpp``): a
    robust process-shared mutex and two payload slots of ``size`` bytes.
    Raises if the engine cannot be built, or if the file holds content
    that is neither all zero nor a native store."""

    def __init__(self, path, size):
        self._h = None
        self._lib = lib = get_shm_lib()
        status = ctypes.c_int()
        self._h = lib.tpl_shm_open(path.encode(), int(size),
                                   ctypes.byref(status))
        if not self._h:
            if status.value == 1:
                raise RuntimeError(
                    f"{path} holds content that is not a native shm store "
                    "(a store of the python engine? remove the file, or set "
                    "TPL_TPU_SHM_ENGINE the same in every process)")
            raise RuntimeError(f"tpl_shm_open failed for {path}")
        self.created = status.value == 2   # this open initialized the store
        self.capacity = lib.tpl_shm_capacity(self._h)
        self._buf = ctypes.create_string_buffer(self.capacity)

    def lock(self):
        """Takes the store's mutex: 0, or 1 where the last owner died
        holding it (the data is its last complete write)."""
        r = self._lib.tpl_shm_lock(self._h)
        if r < 0:
            raise RuntimeError("tpl_shm_lock failed")
        return r

    def unlock(self):
        self._lib.tpl_shm_unlock(self._h)

    def version(self):
        return self._lib.tpl_shm_version(self._h)

    def read(self):
        """(payload bytes, version) of the readable slot; the caller holds
        the lock."""
        ver = ctypes.c_uint64()
        n = self._lib.tpl_shm_read(self._h, self._buf, self.capacity,
                                   ctypes.byref(ver))
        if n < 0:
            raise RuntimeError("shm payload larger than capacity")
        return ctypes.string_at(self._buf, n), ver.value

    def write(self, blob):
        """Fills the other slot with ``blob`` and makes it readable; returns
        the new version.  The caller holds the lock."""
        ver = self._lib.tpl_shm_write(self._h, blob, len(blob))
        if ver == 0:
            raise RuntimeError(
                f"shm store overflow: {len(blob)} > {self.capacity}")
        return ver

    def close(self):
        if self._h:
            self._lib.tpl_shm_close(self._h)
            self._h = None

    def __del__(self):
        self.close()
