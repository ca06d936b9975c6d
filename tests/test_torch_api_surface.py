"""The port's public surface: every exported name of each port module
resolves, and every name that the JAX package exports has a counterpart of
the same name in the port, but for the exceptions below, each with the
reason ``ROADMAP.md`` ("Not to port") gives. Also the re-export of
``hot_ids_by_degree`` and ``WGTPU_DIRECT_IO``, the environment's default
for O_DIRECT loads, in each of the four loaders."""

import importlib
import inspect

import numpy as np
import pytest

from test_api_surface import MODULES

PORT = "wholegraph_tpu_torch"
# the JAX modules compared; testing.py's replicas are the tests' oracles and interop.py
# bridges JAX and torch, so neither has a counterpart
COMPARED = [m for m in MODULES if m.rsplit(".", 1)[-1] not in ("testing", "interop")]
PORT_MODULES = [PORT + m[len("wholegraph_tpu"):] for m in COMPARED]
EXCEPTIONS = {
    ("wholegraph_tpu.embedding", "EmbeddingState"):
        "the port's tables are updated in place: there is no state object",
    ("wholegraph_tpu.embedding", "HostEmbeddingState"):
        "the port's host tables are updated in place: there is no state object",
    ("wholegraph_tpu.utils", "as_jax_dtype"): "JAX dtypes do not apply to the port",
    ("wholegraph_tpu.ops", "host_gather_rows_window"):
        "a Pallas wrapper of gather_pallas.py: kernel E (ops.host_gather_rows) does its work",
    ("wholegraph_tpu.ops", "gather"):
        "ported under another path: the store's gather is ops.gather.gather, and ops.gather "
        "stays the module that the port's callers import",
}


@pytest.mark.parametrize("mod", PORT_MODULES)
def test_port_module_all_resolves(mod):
    m = importlib.import_module(mod)
    names = getattr(m, "__all__", [])
    assert names or mod.endswith(".config"), f"{mod} has no __all__"
    for name in names:
        assert getattr(m, name, None) is not None, f"{mod}.{name} missing"


@pytest.mark.parametrize("mod", COMPARED)
def test_every_jax_name_has_a_counterpart(mod):
    """A JAX name is matched by a port name of the same kind: a module by a
    module, anything else by a non-module."""
    jm = importlib.import_module(mod)
    tm = importlib.import_module(PORT + mod[len("wholegraph_tpu"):])
    names = getattr(jm, "__all__", None)
    if names is None:  # config.py: its public functions
        names = [n for n, v in vars(jm).items() if inspect.isfunction(v) and not n.startswith("_")
                 and v.__module__ == jm.__name__]
    missing = []
    for name in names:
        if (mod, name) in EXCEPTIONS:
            continue
        got = getattr(tm, name, None)
        if got is None or inspect.ismodule(got) != inspect.ismodule(getattr(jm, name)):
            missing.append(name)
    assert not missing, f"{mod}: no counterpart in the port for {missing}"


@pytest.mark.parametrize("key", list(EXCEPTIONS))
def test_each_exception_is_still_one(key):
    """An exception stays listed only while the port lacks the name, or
    (ops.gather) holds a module under it."""
    mod, name = key
    assert name in importlib.import_module(mod).__all__
    got = getattr(importlib.import_module(PORT + mod[len("wholegraph_tpu"):]), name, None)
    assert got is None or inspect.ismodule(got), key


def test_port_entry_points():
    import wholegraph_tpu_torch as wt
    from wholegraph_tpu_torch import version
    from wholegraph_tpu_torch.ops import gather as tg

    assert inspect.ismodule(tg) and tg is wt.ops.gather and callable(tg.gather)
    assert wt.ops.scatter is tg.scatter and wt.ops.gather_hierarchical is tg.gather_hierarchical
    assert wt.ops.gather_overflow is tg.gather_overflow
    assert inspect.ismodule(wt.ops.spmm) and callable(wt.ops.spmm_window)
    assert callable(wt.ops.choose_gather_kernel) and callable(wt.ops.window_coverage)
    assert callable(wt.ops.gather_rows_window)
    assert wt.__version__ == version.__version__
    assert wt.utils.as_numpy_dtype("float32") == np.float32


def test_hot_ids_by_degree_is_re_exported():
    from wholegraph_tpu.embedding import host_embedding as jhe
    from wholegraph_tpu_torch.embedding import cache, host_embedding

    assert host_embedding.hot_ids_by_degree is cache.hot_ids_by_degree
    row_ptr = np.concatenate([[0], np.cumsum(np.random.RandomState(0).randint(0, 9, 50))])
    np.testing.assert_array_equal(host_embedding.hot_ids_by_degree(row_ptr, 0.2),
                                  jhe.hot_ids_by_degree(row_ptr, 0.2))


class _Spy:
    """The native library with its reader's O_DIRECT flag recorded."""

    def __init__(self, lib, flags):
        self._lib, self._flags = lib, flags

    def __getattr__(self, name):
        return getattr(self._lib, name)

    @property
    def wgtpu_read_rows_v2(self):
        def read(*args):
            self._flags.append(args[8])
            return self._lib.wgtpu_read_rows_v2(*args)
        return read


@pytest.fixture
def native_env(monkeypatch):
    """``(set_env, flags)``: ``set_env(value)`` re-imports ``io.native``
    with ``WGTPU_DIRECT_IO`` set to ``value`` (None: unset), as a process
    started so would read it; ``flags`` collects the O_DIRECT flag of every
    read. The module is re-imported with the variable as it was afterwards."""
    from wholegraph_tpu_torch.io import native

    flags = []
    lib = native._lib

    def set_env(value):
        if value is None:
            monkeypatch.delenv("WGTPU_DIRECT_IO", raising=False)
        else:
            monkeypatch.setenv("WGTPU_DIRECT_IO", value)
        importlib.reload(native)
        monkeypatch.setattr(native, "_lib", lambda: _Spy(lib(), flags))

    yield set_env, flags
    monkeypatch.undo()
    importlib.reload(native)


def _read_rows(path, rows, dim, **kw):
    from wholegraph_tpu_torch.io import native

    out = np.empty(rows * dim * 4, np.uint8)
    native.read_rows_native([path], [0, rows], dim * 4, 0, rows, out, **kw)
    return out.view(np.float32).reshape(rows, dim)


def _loaders():
    """Each loader as ``f(path, rows, dim, **kw) -> the rows read``."""
    import wholegraph_tpu_torch as wt

    return {
        "read_rows_native": _read_rows,
        "load_filelist": lambda path, rows, dim, **kw: wt.io.load_filelist(
            [path], dim, "float32", device="cpu", **kw).to_array(),
        "ShardedTable.from_filelist": lambda path, rows, dim, **kw: wt.ShardedTable.from_filelist(
            [path], dim, "float32", device="cpu", **kw).to_array(),
        "Embedding.from_filelist": lambda path, rows, dim, **kw: wt.embedding.Embedding
        .from_filelist([path], dim, device="cpu", **kw).to_array(),
    }


LOADERS = ("read_rows_native", "load_filelist", "ShardedTable.from_filelist",
           "Embedding.from_filelist")


@pytest.mark.parametrize("loader", LOADERS)
@pytest.mark.parametrize("env, direct, want", [
    ("1", None, 1), (None, None, 0), ("0", None, 0), ("1", False, 0), (None, True, 1)])
def test_direct_io_follows_the_environment(native_env, tmp_path, loader, env, direct, want):
    """``WGTPU_DIRECT_IO=1`` makes ``direct=None`` request O_DIRECT (read
    at import, as JAX's ``io/native.py:77`` reads it); an explicit
    ``direct`` wins. The rows read are the file's whichever the file
    system grants."""
    set_env, flags = native_env
    rows, dim = 64, 8
    arr = np.random.RandomState(3).randn(rows, dim).astype(np.float32)
    path = str(tmp_path / "rows.bin")
    arr.tofile(path)
    set_env(env)
    kw = {} if direct is None else {"direct": direct}
    got = _loaders()[loader](path, rows, dim, **kw)
    assert flags and set(flags) == {want}, flags
    np.testing.assert_array_equal(got, arr)
