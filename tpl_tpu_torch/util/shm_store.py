"""
File-backed shared-memory store for multi-process deployments.

The reference uses ``structstore``: a C++ shared-memory store library with
per-store process-shared mutexes (reference: library/tpl/util.py:310-333).
The port of ``tpl_tpu/util/shm_store.py``: one mmap'd file per store, its
native engine (``tpl_tpu_torch/native/shmstore.cpp``) holding a robust
process-shared pthread mutex and double-buffered pickle payload slots (a
writer crash can never tear the readable slot; a lock holder's death is
recovered via EOWNERDEAD).  ``lock()`` refreshes the local mirror on entry
and publishes it on exit, matching the reference's snapshot-in /
snapshot-out usage pattern.

Where the JAX package's store differs:

- the stores live in their own directory, :data:`SHM_DIR`
  (``<tmp>/tpl-tpu-torch-shm-<uid>``), so the port never opens a JAX store
  (unpickling one would import ``jax``);
- the native engine is the only one unless ``TPL_TPU_SHM_ENGINE=python``
  asks for the pure-Python engine (an fcntl file lock, one payload
  buffer).  A failed native build raises; nothing falls back.  Each engine
  refuses the other's file, and a payload that does not unpickle raises;
- a write that fails (an overflow) raises, releases the thread's lock
  too, and makes the next lock reload the last published state (the JAX
  store keeps the rejected value in its mirror, and its thread lock);
- a reference held across another process's write stays valid: when a
  lock or :meth:`ShmStore.revalidate` loads a newer version, a top-level
  value that is an object with a ``__dict__`` (a ``Bundle``, a planner's
  params) and has the same type on both sides takes the new contents in
  place.  So the bundle a planner or controller holds (``ComponentRegistry``
  hands each its store value once) sees the GUI's or the sim's edits, and
  its own writes are published on the next exit.  Other values are
  replaced, as in the JAX package.
"""

import os
import mmap
import time
import types
import pickle
import struct
import fcntl
import tempfile
import threading

from tpl_tpu_torch.util import Bundle, snapshot, store_paths

_HEADER = struct.Struct("<QQ")  # version, payload length (python engine)
_NATIVE_MAGIC = b"TPLSHM01"

SHM_DIR = os.path.join(tempfile.gettempdir(),
                       f"tpl-tpu-torch-shm-{os.getuid()}")


def _engine():
    name = os.environ.get("TPL_TPU_SHM_ENGINE", "") or "native"
    if name not in ("native", "python"):
        raise ValueError(f"TPL_TPU_SHM_ENGINE={name!r}: native or python")
    return name


def _adopt(held, fresh):
    """Gives each top-level object of ``held`` that ``fresh`` has again
    (same key, same type, a plain ``__dict__``) the fresh contents in place,
    and puts the held object into ``fresh``; returns ``fresh``."""
    for key, new in fresh.items():
        old = held.get(key)
        if (old is None or old is new or type(old) is not type(new)
                or isinstance(old, (type, types.FunctionType,
                                    types.ModuleType))
                or not isinstance(getattr(old, "__dict__", None), dict)):
            continue
        old.__dict__.clear()
        old.__dict__.update(new.__dict__)
        fresh[key] = old
    return fresh


def file_path(path):
    """The file that backs the store named ``path``."""
    return os.path.join(SHM_DIR, path.lstrip("/").replace("/", "_"))


def remove_app_stores(app_id):
    """Deletes the store files of every store :func:`store_paths` names for
    ``app_id`` (a finished deployment's, or a test's)."""
    for path in store_paths(app_id).values():
        try:
            os.remove(file_path(path))
        except FileNotFoundError:
            pass


class ShmStore:

    SHM_DIR = SHM_DIR

    def __init__(self, path, size=10 ** 7, reinit=False):
        os.makedirs(self.SHM_DIR, exist_ok=True)
        self._file_path = file_path(path)
        self._size = size

        new = not os.path.exists(self._file_path)

        object.__setattr__(self, "_attrs", {})
        self._version = -1
        self._tlock = threading.RLock()
        self._lock_depth = 0

        self._native = None
        self._fd = None
        self._mm = None
        if _engine() == "native":
            from tpl_tpu_torch.native import NativeShm
            self._native = NativeShm(self._file_path, size)
        else:
            self._fd = os.open(self._file_path,
                               os.O_RDWR | os.O_CREAT, 0o600)
            cur = os.fstat(self._fd).st_size
            if cur >= 8 and not new:
                with open(self._file_path, "rb") as f:
                    if f.read(8) == _NATIVE_MAGIC:
                        raise RuntimeError(
                            f"{self._file_path} was created by the native "
                            "shm engine; this process runs the python "
                            "engine (set TPL_TPU_SHM_ENGINE the same in "
                            "every process, or remove the stale store file)")
            if cur < size + _HEADER.size:
                os.ftruncate(self._fd, size + _HEADER.size)
            self._mm = mmap.mmap(self._fd, size + _HEADER.size)

        # a store the native engine initialized in this open is empty
        # already: publishing {} again could wipe a write another process
        # made since
        if reinit or (new and self._native is None):
            with self.lock():
                self._attrs.clear()

    # internal ------------------------------------------------------

    def _load(self, blob, version):
        attrs = pickle.loads(blob) if blob else {}
        self._attrs = _adopt(self._attrs, attrs)
        self._version = version

    def _read_locked(self):
        if self._native is not None:
            if self._native.version() != self._version:
                self._load(*self._native.read())
            return
        version, length = _HEADER.unpack(self._mm[:_HEADER.size])
        if version != self._version and length > 0:
            try:
                blob = self._mm[_HEADER.size:_HEADER.size + length]
                self._load(blob, version)
            except Exception as e:
                raise RuntimeError(
                    f"shm store {self._file_path}: version {version} does "
                    "not unpickle (a writer died mid-write?)") from e

    def _write_locked(self):
        blob = pickle.dumps(self._attrs, protocol=pickle.HIGHEST_PROTOCOL)
        if self._native is not None:
            try:
                self._version = self._native.write(blob)
            except RuntimeError:
                self._version = -1    # the next lock reloads the store
                raise
            return
        if len(blob) > self._size:
            self._version = -1
            raise RuntimeError(
                f"shm store {self._file_path} overflow: "
                f"{len(blob)} > {self._size}")
        self._version += 1
        self._mm[_HEADER.size:_HEADER.size + len(blob)] = blob
        self._mm[:_HEADER.size] = _HEADER.pack(self._version, len(blob))

    def _acquire_file(self):
        if self._native is not None:
            self._native.lock()
        else:
            fcntl.flock(self._fd, fcntl.LOCK_EX)

    def _release_file(self):
        if self._native is not None:
            self._native.unlock()
        else:
            fcntl.flock(self._fd, fcntl.LOCK_UN)

    # public --------------------------------------------------------

    def lock(self):
        store = self

        class _Ctx:
            def __enter__(ctx):
                store._tlock.acquire()
                store._lock_depth += 1
                if store._lock_depth == 1:
                    store._acquire_file()
                    try:
                        store._read_locked()
                    except BaseException:
                        store._lock_depth -= 1
                        store._release_file()
                        store._tlock.release()
                        raise
                return store

            def __exit__(ctx, *exc):
                store._lock_depth -= 1
                try:
                    if store._lock_depth == 0:
                        try:
                            store._write_locked()
                        finally:
                            store._release_file()
                finally:
                    store._tlock.release()
                return False

        return _Ctx()

    def revalidate(self):
        with self._tlock:
            self._acquire_file()
            try:
                self._read_locked()
            finally:
                self._release_file()

    def shm_version(self):
        """The version last published to the store (by any process); read
        without the lock."""
        if self._native is not None:
            return self._native.version()
        return _HEADER.unpack(self._mm[:_HEADER.size])[0]

    def wait_for_attr(self, name, timeout=-1.0):
        start = time.time()
        while True:
            self.revalidate()
            if name in self._attrs:
                return True
            if 0.0 <= timeout < time.time() - start:
                return False
            time.sleep(0.01)

    def deepcopy(self):
        with self.lock():
            return snapshot(Bundle(**self._attrs))

    def keys(self):
        return self._attrs.keys()

    def items(self):
        return self._attrs.items()

    def __contains__(self, k):
        return k in self._attrs

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        try:
            return object.__getattribute__(self, "_attrs")[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name, value):
        if name.startswith("_"):
            object.__setattr__(self, name, value)
        else:
            self._attrs[name] = value


class ShmObject:
    """Share a whole python object between processes (make_class_shared
    analog over the shm substrate): ``lock()`` refreshes the local object
    from shared memory on entry and publishes it on exit; methods keep
    working on the local mirror.  The store holds one attribute, ``state``:
    the object's ``__dict__``."""

    def __init__(self, obj, path, size=10 ** 7, reinit=False):
        object.__setattr__(self, "_obj", obj)
        object.__setattr__(self, "_shm", ShmStore(path, size=size,
                                                  reinit=reinit))

    def _pull(self):
        state = getattr(self._shm, "state", None)
        if state is not None:
            object.__getattribute__(self, "_obj").__dict__ = state

    def lock(self):
        shared = self

        class _Ctx:
            def __enter__(ctx):
                ctx._inner = shared._shm.lock()
                ctx._inner.__enter__()
                shared._pull()
                return shared

            def __exit__(ctx, *exc):
                shared._shm.state = object.__getattribute__(
                    shared, "_obj").__dict__
                return ctx._inner.__exit__(*exc)

        return _Ctx()

    def revalidate(self):
        self._shm.revalidate()
        self._pull()

    def wait_for_attr(self, name, timeout=-1.0):
        """Waits until a process has published the object with attribute
        ``name`` (as :meth:`ShmStore.wait_for_attr`)."""
        start = time.time()
        while True:
            self._shm.revalidate()
            if name in (getattr(self._shm, "state", None) or {}):
                self._pull()
                return True
            if 0.0 <= timeout < time.time() - start:
                return False
            time.sleep(0.01)

    def unwrap(self):
        return object.__getattribute__(self, "_obj")

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(object.__getattribute__(self, "_obj"), name)

    def __setattr__(self, name, value):
        if name.startswith("_"):
            object.__setattr__(self, name, value)
        else:
            setattr(object.__getattribute__(self, "_obj"), name, value)
