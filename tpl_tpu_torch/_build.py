"""
Build-at-first-use for the hand-written CUDA kernels under ``csrc/``.

Each kernel source is compiled by ``nvcc`` into a shared library with a
plain C interface and loaded with ``ctypes``.  Libraries land in
``build/tpl_tpu_torch/`` at the repository root, keyed by a hash of the
source, the ``csrc/`` headers it includes and the flags, so an edited source
or header rebuilds and an unchanged one loads straight away.  A missing
``nvcc`` or a failed compile raises with the compiler's output; there is no
fallback.
"""

import ctypes
import hashlib
import os
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


def _paths(name, csrc=None):
    src = os.path.join(csrc or CSRC, name + ".cu")
    tag = hashlib.sha1(_sources(src, set()) + " ".join(NVCC_FLAGS).encode()
                       ).hexdigest()[:16]
    return src, os.path.join(BUILD_DIR, f"{name}_{tag}.so")


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
