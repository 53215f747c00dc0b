"""The port's shared-memory stores (``tpl_tpu_torch.util.shm_store``, the
native engine ``tpl_tpu_torch/native/shmstore.cpp``).

- The seven cases of tests/test_shm_store.py on the port: a child process
  writes and the parent reads, a shared object bumped by a child, the
  re-entrant lock, four children's increments under the lock losing none,
  a lock holder's death recovered with the last complete write, the Python
  engine when ``TPL_TPU_SHM_ENGINE=python`` asks for it, the native engine
  by default.  The children are fresh interpreters (``python -c``), so
  none imports jax.
- A failed native build raises (``CXX=false`` and an empty build
  directory); nothing falls back to the Python engine.
- The port's store directory is not the JAX package's, and each engine
  refuses a file of the other.
- An overflow raises in both engines.
- A bundle held across another process's write sees that write, and the
  holder's own edit is published on its next exit; the JAX store loses
  both (asserted as the recorded difference).
- One sequence of operations against ``tpl_tpu.util.shm_store`` and the
  port's store shows the same values and versions.
"""

import os
import subprocess
import sys
import textwrap
import uuid

import numpy as np
import pytest

from tpl_tpu_torch.util import Bundle, shm_store
from tpl_tpu_torch.util.shm_store import ShmObject, ShmStore

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PAYLOAD = """
import numpy as np
class Payload:
    def __init__(self):
        self.t = 0.0
        self.values = np.zeros(3)
    def bump(self):
        self.t += 1.0
        self.values = self.values + 1.0
"""


def _child(code, *args, engine=None, env=None, check=True):
    """Runs ``code`` in a fresh interpreter with the port importable and
    ``sys.argv[1:]`` = ``args``; fails the test on a non-zero exit unless
    ``check`` is False.  Returns the completed process."""
    env = dict(os.environ, PYTHONPATH=REPO, **(env or {}))
    if engine is not None:
        env["TPL_TPU_SHM_ENGINE"] = engine
    else:
        env.pop("TPL_TPU_SHM_ENGINE", None)
    res = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(code), *map(str, args)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    if check:
        assert res.returncode == 0, res.stdout + res.stderr
    return res


_MADE = []


def _name(tag):
    """A fresh store name; its files (the port's, and the JAX store's where
    a test opens one) are removed after the test."""
    name = f"/test_{tag}_{uuid.uuid4().hex[:8]}"
    _MADE.append(name)
    return name


@pytest.fixture(autouse=True)
def remove_store_files():
    yield
    dirs = [shm_store.SHM_DIR]
    if "tpl_tpu.util.shm_store" in sys.modules:
        dirs.append(sys.modules["tpl_tpu.util.shm_store"].ShmStore.SHM_DIR)
    for name in _MADE:
        for d in dirs:
            try:
                os.remove(os.path.join(d, name.lstrip("/")))
            except FileNotFoundError:
                pass
    _MADE.clear()


@pytest.fixture
def python_engine(monkeypatch):
    monkeypatch.setenv("TPL_TPU_SHM_ENGINE", "python")


def test_shm_store_cross_process():
    path = _name("xp")
    store = ShmStore(path, reinit=True)
    with store.lock():
        store.request = 42
    _child("""
        import sys
        import numpy as np
        from tpl_tpu_torch.util.shm_store import ShmStore
        store = ShmStore(sys.argv[1])
        with store.lock():
            assert store.request == 42
            store.reply = {"arr": np.arange(5.0), "msg": "hello"}
    """, path)
    assert store.wait_for_attr("reply", timeout=5.0)
    with store.lock():
        assert store.request == 42
        np.testing.assert_array_equal(store.reply["arr"], np.arange(5.0))
        assert store.reply["msg"] == "hello"


def test_shm_object_cross_process():
    path = _name("obj")
    ns = {}
    exec(_PAYLOAD, ns)
    obj = ShmObject(ns["Payload"](), path, reinit=True)
    with obj.lock():
        obj.t = 5.0
    _child(_PAYLOAD + """
import sys
from tpl_tpu_torch.util.shm_store import ShmObject
obj = ShmObject(Payload(), sys.argv[1])
with obj.lock():
    obj.unwrap().bump()
""", path)
    with obj.lock():
        assert obj.t == 6.0
        np.testing.assert_array_equal(obj.values, np.ones(3))


def test_shm_store_lock_reentrant():
    store = ShmStore(_name("re"), reinit=True)
    with store.lock():
        store.a = 1
        with store.lock():
            store.b = 2
    store.revalidate()
    assert store.a == 1 and store.b == 2


def test_shm_store_mutual_exclusion():
    """4 processes x 50 increments under the store lock lose no update."""
    path = _name("mx")
    store = ShmStore(path, reinit=True)
    with store.lock():
        store.counter = 0
    code = textwrap.dedent("""
        import sys
        from tpl_tpu_torch.util.shm_store import ShmStore
        store = ShmStore(sys.argv[1])
        for _ in range(int(sys.argv[2])):
            with store.lock():
                store.counter = store.counter + 1
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("TPL_TPU_SHM_ENGINE", None)
    procs = [subprocess.Popen([sys.executable, "-c", code, path, "50"],
                              cwd=REPO, env=env) for _ in range(4)]
    for p in procs:
        assert p.wait(120) == 0
    store.revalidate()
    assert store.counter == 200


@pytest.mark.parametrize("engine", [None, "python"])
def test_shm_store_dead_owner_recovery(engine, monkeypatch):
    """A lock holder's death must not deadlock the store, and the last
    complete write must survive (native engine: robust mutex EOWNERDEAD
    + double-buffered slots; python engine: flock auto-release)."""
    if engine:
        monkeypatch.setenv("TPL_TPU_SHM_ENGINE", engine)
    path = _name("dead")
    store = ShmStore(path, reinit=True)
    with store.lock():
        store.safe = "committed"
    res = _child("""
        import os, sys
        from tpl_tpu_torch.util.shm_store import ShmStore
        store = ShmStore(sys.argv[1])
        ctx = store.lock()
        ctx.__enter__()
        store._attrs["held"] = True
        os._exit(1)  # dies while holding the store lock
    """, path, engine=engine, check=False)
    assert res.returncode == 1, res.stderr

    store.revalidate()  # must not hang
    assert store.safe == "committed"
    assert "held" not in store
    with store.lock():
        store.after = 1
    store.revalidate()
    assert store.after == 1


def test_shm_store_python_engine_when_asked(python_engine):
    """The pure-python engine runs (python <-> python) when
    ``TPL_TPU_SHM_ENGINE=python`` asks for it, and only then."""
    path = _name("py")
    store = ShmStore(path, reinit=True)
    assert store._native is None
    with store.lock():
        store.request = 1
    _child("""
        import sys
        from tpl_tpu_torch.util.shm_store import ShmStore
        store = ShmStore(sys.argv[1])
        assert store._native is None
        with store.lock():
            store.fallback_reply = store.request + 6
    """, path, engine="python")
    assert store.wait_for_attr("fallback_reply", timeout=5.0)
    with store.lock():
        assert store.fallback_reply == 7


def test_shm_store_native_engine_active(monkeypatch):
    """The native engine is the default, built by g++ at first use."""
    monkeypatch.delenv("TPL_TPU_SHM_ENGINE", raising=False)
    store = ShmStore(_name("nat"), reinit=True)
    assert store._native is not None
    monkeypatch.setenv("TPL_TPU_SHM_ENGINE", "native")
    assert ShmStore(_name("nat"), reinit=True)._native is not None
    monkeypatch.setenv("TPL_TPU_SHM_ENGINE", "fast")
    with pytest.raises(ValueError, match="native or python"):
        ShmStore(_name("nat"))


def test_failed_native_build_raises(tmp_path):
    """A compiler that fails, with nothing built yet, raises from the
    store's constructor: no store falls back to the Python engine."""
    res = _child("""
        import sys
        from tpl_tpu_torch import _build
        from tpl_tpu_torch.util.shm_store import ShmStore
        _build.BUILD_DIR = sys.argv[1]
        try:
            ShmStore(sys.argv[2])
        except RuntimeError as e:
            print("raised:", str(e).splitlines()[0])
        else:
            print("opened")
    """, tmp_path / "build", _name("nobuild"), env={"CXX": "false"})
    assert "raised: building shmstore.cpp failed" in res.stdout, res.stdout
    assert not list((tmp_path / "build").glob("*.so"))


def test_store_directory_is_the_ports_own():
    from tpl_tpu.util import shm_store as jax_shm
    assert shm_store.SHM_DIR != jax_shm.ShmStore.SHM_DIR
    assert ShmStore.SHM_DIR == shm_store.SHM_DIR
    assert os.path.basename(shm_store.SHM_DIR).startswith(
        "tpl-tpu-torch-shm-")

    # one name, two stores: the JAX package's and the port's never meet
    name = _name("dir")
    ours = ShmStore(name, reinit=True)
    with ours.lock():
        ours.side = "port"
    theirs = jax_shm.ShmStore(name, reinit=True)
    with theirs.lock():
        theirs.side = "jax"
    ours.revalidate()
    assert ours.side == "port"
    assert ours._file_path != theirs._file_path


def test_each_engine_refuses_the_others_file(monkeypatch):
    native_name, python_name = _name("nf"), _name("pf")
    monkeypatch.delenv("TPL_TPU_SHM_ENGINE", raising=False)
    with ShmStore(native_name, reinit=True).lock() as s:
        s.a = 1
    monkeypatch.setenv("TPL_TPU_SHM_ENGINE", "python")
    with pytest.raises(RuntimeError, match="created by the native"):
        ShmStore(native_name)
    with ShmStore(python_name, reinit=True).lock() as s:
        s.a = 1
    monkeypatch.delenv("TPL_TPU_SHM_ENGINE")
    with pytest.raises(RuntimeError, match="not a native shm store"):
        ShmStore(python_name)
    # the refused files are untouched
    monkeypatch.setenv("TPL_TPU_SHM_ENGINE", "python")
    store = ShmStore(python_name)
    store.revalidate()
    assert store.a == 1


@pytest.mark.parametrize("engine", [None, "python"])
def test_overflow_raises(engine, monkeypatch):
    if engine:
        monkeypatch.setenv("TPL_TPU_SHM_ENGINE", engine)
    else:
        monkeypatch.delenv("TPL_TPU_SHM_ENGINE", raising=False)
    store = ShmStore(_name("of"), size=4096, reinit=True)
    with pytest.raises(RuntimeError, match="overflow"):
        with store.lock():
            store.big = np.zeros(1024)
    with store.lock():
        store.small = 1
    store.revalidate()
    assert store.small == 1 and "big" not in store


_EDIT_PARAM = """
import sys
from tpl_tpu_torch.util.shm_store import ShmStore
store = ShmStore(sys.argv[1])
with store.lock():
    store.comp.params.k = 2
"""


def test_held_bundle_sees_other_writes_and_publishes_its_own():
    """A component holds its bundle as ``ComponentRegistry`` hands it out
    (a reference to the store value).  Another process edits the bundle's
    params; the held bundle shows the edit at the next lock, and the
    component's own write under that lock reaches the other side."""
    path = _name("held")
    store = ShmStore(path, reinit=True)
    with store.lock():
        store.comp = Bundle(params=Bundle(k=1), debug=Bundle())
        held = store.comp
    _child(_EDIT_PARAM, path)
    with store.lock():
        assert store.comp is held
        assert held.params.k == 2
        held.debug.seen = held.params.k
    res = _child("""
        import sys
        from tpl_tpu_torch.util.shm_store import ShmStore
        store = ShmStore(sys.argv[1])
        store.revalidate()
        print(store.comp.debug.seen, store.comp.params.k)
    """, path)
    assert res.stdout.split() == ["2", "2"]


@pytest.mark.parametrize("package", ["jax", "port"])
def test_held_bundle_two_stores_on_one_file(package):
    """The same held-bundle case with two stores on one file in this
    process, against both packages: the port's held bundle takes the
    other store's edit and its own write reaches the other store; the JAX
    store replaces the attribute dict on a new version, so the held bundle
    keeps k = 1 and its write is lost (the difference recorded in
    ROADMAP.md section 3)."""
    if package == "jax":
        from tpl_tpu.util.shm_store import ShmStore as Store
        from tpl_tpu.util import Bundle as B
    else:
        Store, B = ShmStore, Bundle
    path = _name("two")
    a = Store(path, reinit=True)
    with a.lock():
        a.comp = B(params=B(k=1), debug=B())
        held = a.comp
    b = Store(path)
    with b.lock():
        b.comp.params.k = 2
    with a.lock():
        current = a.comp
        held.debug.seen = held.params.k
    b.revalidate()
    seen = getattr(b.comp.debug, "seen", None)
    if package == "port":
        assert current is held and held.params.k == 2 and seen == 2
    else:
        assert current is not held and held.params.k == 1 and seen is None
        assert current.params.k == 2


def _sequence(Store, name):
    """Values and versions seen by one sequence of store operations."""
    out = []
    a = Store(name, reinit=True)
    out.append(("open", a._version, sorted(a.keys())))
    with a.lock():
        a.x = 1.5
        with a.lock():
            a.arr = np.arange(3.0)
    out.append(("nested", a._version, a.x, a.arr.tolist()))
    b = Store(name)
    out.append(("second", b._version, sorted(b.keys())))
    b.revalidate()
    out.append(("revalidate", b._version, b.x, "arr" in b))
    with b.lock():
        b.x = b.x + 1.0
        del b._attrs["arr"]
        b.items_ = {"k": [1, 2]}
    a.revalidate()
    out.append(("other", a._version, a.x, sorted(a.keys())))
    out.append(("wait", a.wait_for_attr("items_", timeout=1.0),
                a.wait_for_attr("nope", timeout=0.05)))
    copy = a.deepcopy()
    out.append(("deepcopy", a._version, sorted(copy.keys()),
                copy.items_ == {"k": [1, 2]}, copy.items_ is not a.items_))
    c = Store(name, reinit=True)
    a.revalidate()
    out.append(("reinit", c._version, a._version, sorted(a.keys())))
    return out


def test_store_operations_match_the_jax_store():
    """One sequence against both stores (native engines): the same
    attributes, values and versions after every step.  It opens its store
    with ``reinit``: on a fresh file the JAX store publishes an empty
    payload (version 1), where the port's native open leaves the store it
    initialised empty at version 0 (so that two processes that start
    together cannot wipe each other's first writes)."""
    from tpl_tpu.util.shm_store import ShmStore as JaxStore
    name = _name("seq")
    assert _sequence(JaxStore, name) == _sequence(ShmStore, name)
    fresh = ShmStore(_name("fresh"))
    assert fresh._version == -1 and not list(fresh.keys())
    fresh.revalidate()
    assert fresh._version == 0
