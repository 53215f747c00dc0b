"""
Hot code reloading for the application loops.

The reference wraps every app's update loop in
``minireload.WrappingReloader`` so that edits to planner/controller code
take effect live, without restarting the process or losing the shared
stores (reference: library/tpl/application/planning_app.py:131,
library/tpl/simulation/tplsim:40-45). This module provides the same
capability natively:

- :class:`WrappingReloader` polls the source files of every loaded module
  under the watched packages (default: ``tpl_tpu_torch``) between calls,
- on change, the module is re-executed with :func:`importlib.reload` and
  its old top-level functions/classes are **patched in place**: function
  objects get the new ``__code__``/``__defaults__`` (so bound methods and
  ``from x import f`` references update too), classes get their methods
  and attributes transplanted onto the original class object (so live
  planner/controller/sim instances pick up the new behavior immediately),
- a broken edit (syntax error, import failure) never kills the loop: the
  old code keeps running and the traceback is printed once per change.

Compiled code is state, not module code: the CUDA kernel libraries loaded
by ``tpl_tpu_torch._build`` and the update functions a ``Solver`` keeps
survive a reload, as the reference's compiled genopt .so does.  An edited
kernel source is rebuilt at the next process start.

The port of tpl_tpu/util/hotreload.py (standard library only).
"""

import os
import sys
import time
import types
import traceback
import importlib


_FUNC_ATTRS = ("__code__", "__defaults__", "__kwdefaults__", "__doc__")


def _patch_function(old, new):
    """Update ``old`` in place so every existing reference to it (bound
    methods, imported names) runs the new code. Returns True on success."""
    if old is new:
        return True
    old_clo = len(old.__code__.co_freevars)
    new_clo = len(new.__code__.co_freevars)
    if old_clo != new_clo:
        return False  # closure layout changed; caller rebinds instead
    for attr in _FUNC_ATTRS:
        try:
            setattr(old, attr, getattr(new, attr))
        except (AttributeError, ValueError):
            return False
    old.__dict__.update(new.__dict__)
    return True


def _patch_class(old, new):
    """Transplant the new class body onto the old class object so live
    instances (whose ``type`` is the old object) behave like the new."""
    for name, new_attr in list(vars(new).items()):
        if name in ("__dict__", "__weakref__"):
            continue
        old_attr = vars(old).get(name)
        if (isinstance(new_attr, types.FunctionType)
                and isinstance(old_attr, types.FunctionType)
                and _patch_function(old_attr, new_attr)):
            continue
        if (isinstance(new_attr, (staticmethod, classmethod))
                and isinstance(old_attr, type(new_attr))
                and _patch_function(old_attr.__func__, new_attr.__func__)):
            continue
        if (isinstance(new_attr, property)
                and isinstance(old_attr, property)):
            try:
                setattr(old, name, new_attr)
                continue
            except (AttributeError, TypeError):
                pass
        try:
            setattr(old, name, new_attr)
        except (AttributeError, TypeError):
            pass
    for name in set(vars(old)) - set(vars(new)):
        if name.startswith("__"):
            continue
        try:
            delattr(old, name)
        except (AttributeError, TypeError):
            pass


def _patch_module(module, old_ns):
    """After ``importlib.reload``, splice the old function/class objects
    back into the module namespace — patched to the new behavior — so
    identity stays stable across reloads (isinstance checks, jit caches on
    instances, subclass registries keep working)."""
    for name, old_obj in old_ns.items():
        new_obj = module.__dict__.get(name)
        if new_obj is None or new_obj is old_obj:
            continue
        if (isinstance(old_obj, types.FunctionType)
                and isinstance(new_obj, types.FunctionType)
                and old_obj.__module__ == new_obj.__module__ == module.__name__):
            if _patch_function(old_obj, new_obj):
                module.__dict__[name] = old_obj
        elif (isinstance(old_obj, type) and isinstance(new_obj, type)
                and old_obj.__module__ == new_obj.__module__ == module.__name__):
            _patch_class(old_obj, new_obj)
            module.__dict__[name] = old_obj


class WrappingReloader:
    """Call-compatible replacement for ``minireload.WrappingReloader``.

    Wraps a callable; before each invocation (rate-limited by
    ``poll_interval`` seconds) it checks the watched packages' source
    mtimes and hot-patches any changed module. Exceptions from the wrapped
    call are caught and printed by default, so a bad edit can be fixed
    live while the loop keeps running.
    """

    def __init__(self, fn, watch=("tpl_tpu_torch",), poll_interval=0.5,
                 catch_exceptions=True, verbose=True):
        self.fn = fn
        self.watch = tuple(watch)
        self.poll_interval = poll_interval
        self.catch_exceptions = catch_exceptions
        self.verbose = verbose
        self._mtimes = {}
        self._last_poll = 0.0
        self._scan(initial=True)

    def _watched_modules(self):
        for name, module in list(sys.modules.items()):
            if module is None or not hasattr(module, "__file__"):
                continue
            if not any(name == w or name.startswith(w + ".")
                       for w in self.watch):
                continue
            f = module.__file__
            if f and f.endswith(".py"):
                yield name, module, f

    def _scan(self, initial=False):
        changed = []
        for name, module, f in self._watched_modules():
            try:
                mtime = os.stat(f).st_mtime_ns
            except OSError:
                continue
            prev = self._mtimes.get(f)
            self._mtimes[f] = mtime
            if prev is not None and mtime != prev and not initial:
                changed.append((name, module))
        for name, module in changed:
            old_ns = dict(module.__dict__)
            try:
                importlib.reload(module)
                _patch_module(module, old_ns)
                if self.verbose:
                    print(f"[hotreload] reloaded {name}", flush=True)
            except Exception:
                module.__dict__.clear()
                module.__dict__.update(old_ns)
                if self.verbose:
                    print(f"[hotreload] reload of {name} failed, "
                          "keeping previous code:", flush=True)
                    traceback.print_exc()
        return bool(changed)

    def __call__(self, *args, **kwargs):
        now = time.monotonic()
        if now - self._last_poll >= self.poll_interval:
            self._last_poll = now
            self._scan()
        try:
            return self.fn(*args, **kwargs)
        except KeyboardInterrupt:
            raise
        except Exception:
            if not self.catch_exceptions:
                raise
            print("[hotreload] exception in wrapped call "
                  "(fix the code to continue):", flush=True)
            traceback.print_exc()
            time.sleep(min(1.0, self.poll_interval))
            return None
