"""
Build-at-first-use for the hand-written CUDA kernels under ``csrc/`` and
for the host C++ routines of ``native/``.

Each kernel source is compiled by ``nvcc`` (:func:`load`), each host source
by ``g++`` (:func:`load_host`), into a shared library with a plain C
interface and loaded with ``ctypes``.  Libraries land in
``build/tpl_tpu_torch/`` at the repository root, keyed by a hash of the
source, the headers it includes from its own directory and the flags, so an
edited source or header rebuilds and an unchanged one loads straight away.
A missing compiler or a failed compile raises with the compiler's output;
there is no fallback.
"""

import ctypes
import hashlib
import os
import platform
import re
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "tpl_tpu_torch")

# no --use_fast_math: the kernels rely on IEEE inf / NaN behaviour;
# --fmad=false keeps every float op rounding like the elementwise reference
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "--fmad=false",
              "-Xptxas", "-v"]

# -ffp-contract=off keeps every float op rounding like the numpy oracles
# (a fused multiply-add flips argmin winners at exact geometric ties)
HOST_FLAGS = ["-O3", "-march=native", "-ffp-contract=off", "-shared",
              "-fPIC"]

_LOCK = threading.Lock()
_LOADED = {}
# compiler output (ptxas register / shared-memory report) per library
BUILD_LOG = {}


def nvcc_path():
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        cand = os.path.join(home, "bin", "nvcc")
        if os.path.isfile(cand):
            return cand
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.isfile(cand):
        return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from csrc/ at first use")


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)


def _sources(path, seen):
    """The bytes of ``path`` and of every ``#include "..."``d file found
    beside it, each once, in include order."""
    if path in seen or not os.path.isfile(path):
        return b""
    seen.add(path)
    with open(path, "rb") as f:
        data = f.read()
    for inc in _INCLUDE.findall(data):
        data += _sources(os.path.normpath(os.path.join(
            os.path.dirname(path), inc.decode())), seen)
    return data


def _library(src, flags, machine=b""):
    """The library path of source ``src`` built with ``flags`` (and for the
    machine described by ``machine``, where the flags depend on it)."""
    name = os.path.splitext(os.path.basename(src))[0]
    tag = hashlib.sha1(_sources(src, set()) + " ".join(flags).encode()
                       + machine).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"{name}_{tag}.so")


def _paths(name, csrc=None):
    src = os.path.join(csrc or CSRC, name + ".cu")
    return src, _library(src, NVCC_FLAGS)


def build(names, csrc=None):
    """Compile every missing ``<name>.cu`` of ``names`` (under ``csrc/``, or
    under the directory ``csrc`` given), one ``nvcc`` per source, all
    started together.  Raises on the first failure."""
    jobs = []
    for name in names:
        src, so = _paths(name, csrc)
        if os.path.exists(so):
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.tmp{os.getpid()}"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, src]
        jobs.append((name, so, tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, so, tmp, cmd, proc in jobs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"building {name} failed ({' '.join(cmd)}):\n{out}")
            continue
        if csrc is None:
            BUILD_LOG[name] = out
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name, csrc=None):
    """Compile (if needed) and load ``csrc/<name>.cu`` (or ``<name>.cu`` of
    another source directory ``csrc``, to hold two versions of a kernel
    against each other); returns the ``ctypes.CDLL``."""
    with _LOCK:
        lib = _LOADED.get((name, csrc))
        if lib is not None:
            return lib
        build([name], csrc)
        lib = ctypes.CDLL(_paths(name, csrc)[1])
        _LOADED[(name, csrc)] = lib
        return lib


def prepare(lib, name):
    """Calls the kernel library's ``<name>_prepare()``: it loads the
    kernels' code onto the current CUDA device (CUDA loads a module lazily,
    at its first launch, by default) and sets their shared-memory limits, so
    that a wrapper that calls it when it binds the library launches at once
    the first time.  Raises on a CUDA error."""
    err = getattr(lib, name + "_prepare")()
    if err != 0:
        raise RuntimeError(f"{name}_prepare failed: CUDA error {err}")


_COUNTERS = {}


def arrival_counter(dev, stream):
    """The int32 word on ``dev`` at which the blocks of a launch on the
    CUDA stream handle ``stream`` count their arrival, so that the last one
    takes the final step (``poly_sampling``, ``poly_propagate``): one a
    (device, stream), zeroed when it is made.  The last block puts it back
    to 0, so no launch clears it and a CUDA graph replays a launch as it
    is; launches on one stream run one after the other, so they share
    it."""
    import torch

    key = (dev.index if dev.index is not None
           else torch.cuda.current_device(), stream)
    word = _COUNTERS.get(key)
    if word is None:
        word = _COUNTERS[key] = torch.zeros(1, dtype=torch.int32, device=dev)
    return word


def gxx_path():
    found = shutil.which(os.environ.get("CXX") or "g++")
    if found:
        return found
    raise RuntimeError("g++ not found (put it on PATH or set CXX); the host "
                       "routines of tpl_tpu_torch/native are built at first "
                       "use")


def _cpu_features():
    """What ``-march=native`` resolves to here: the CPU's feature flags, so
    that a build directory carried to another machine rebuilds there."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            for line in f:
                if line.startswith((b"flags", b"Features")):
                    return line
    except OSError:
        pass
    return platform.machine().encode()


def load_host(src, flags=HOST_FLAGS):
    """Compile (if needed) the host C++ source ``src`` with ``g++`` and
    ``flags`` (:data:`HOST_FLAGS` unless given) and load it; returns the
    ``ctypes.CDLL``."""
    with _LOCK:
        lib = _LOADED.get(src)
        if lib is not None:
            return lib
        if not os.path.isfile(src):
            raise RuntimeError(f"host source {src} not found")
        so = _library(src, flags, _cpu_features())
        if not os.path.exists(so):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so}.tmp{os.getpid()}"
            cmd = [gxx_path(), *flags, "-o", tmp, src]
            done = subprocess.run(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
            if done.returncode != 0:
                if os.path.exists(tmp):
                    os.remove(tmp)
                raise RuntimeError(f"building {os.path.basename(src)} failed "
                                   f"({' '.join(cmd)}):\n{done.stdout}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        _LOADED[src] = lib
        return lib
