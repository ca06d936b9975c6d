"""Hygiene of the port: it imports nothing of JAX or the JAX package, its
entry points refuse to fall back to the CPU when CUDA is missing, and its
kernel module imports and runs the CPU path without building anything."""

import ast
import os
import subprocess

import numpy as np
import pytest
import torch

import wholegraph_tpu_torch as wt
from wholegraph_tpu_torch import kernels
from wholegraph_tpu_torch.embedding import Embedding, HostEmbedding
from wholegraph_tpu_torch.graph import GraphStructure
from wholegraph_tpu_torch.models import HomoGNN
from wholegraph_tpu_torch.ops import KERNELS
from wholegraph_tpu_torch.ops import gather_kernels as G
from wholegraph_tpu_torch.ops import host_kernels as H
from wholegraph_tpu_torch.ops import spmm_kernels as S
from wholegraph_tpu_torch.utils.error import CudaError

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "wholegraph_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "wholegraph_tpu")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(PKG):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_roots(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            for arg in node.args:
                if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                    yield arg.value.split(".")[0]


def test_port_imports_no_jax_nor_the_jax_package():
    files = _port_files()
    assert os.path.join(ROOT, "chip_smoke.py") in files and len(files) > 20
    bad = {(os.path.relpath(f, ROOT), m) for f in files for m in _imported_roots(f)
           if m in FORBIDDEN}
    assert not bad, f"port files import JAX or the JAX package: {sorted(bad)}"


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("entry", ["embedding", "graph", "model", "build_synthetic",
                                   "host_embedding", "build_synthetic_host_tier",
                                   "clustered_csr", "gat_model", "build_full_graph",
                                   "sharded_table", "sharded_table_from_array",
                                   "sharded_table_host"])
def test_default_device_raises_without_cuda(no_cuda, entry):
    calls = {
        "embedding": lambda: Embedding.create(10, 4),
        "graph": lambda: GraphStructure.from_coo(np.array([0, 1]), np.array([1, 0]), 2),
        "model": lambda: HomoGNN(8, 8, 2),
        "build_synthetic": lambda: wt.build_synthetic(wt.SageTrainConfig(n_nodes=10)),
        "host_embedding": lambda: HostEmbedding.create(10, 4),
        "build_synthetic_host_tier": lambda: wt.build_synthetic(wt.SageTrainConfig(n_nodes=10),
                                                                host_cache_ratio=0.25),
        "clustered_csr": lambda: wt.clustered_csr(10, 4, 4),
        "gat_model": lambda: HomoGNN(8, 8, 2, model_type="gat", num_heads=2),
        "build_full_graph": lambda: wt.build_full_graph(wt.FullGraphConfig(n_nodes=10)),
        "sharded_table": lambda: wt.ShardedTable.create(10, 4),
        "sharded_table_from_array": lambda: wt.ShardedTable.from_array(np.zeros((10, 4))),
        "sharded_table_host": lambda: wt.ShardedTable.create(10, 4, location="host"),
    }
    with pytest.raises(CudaError, match="CUDA is not available"):
        calls[entry]()


def test_kernels_import_and_cpu_path_build_nothing(monkeypatch):
    def no_subprocess(*a, **k):
        raise AssertionError("a CPU run must not start nvcc")

    monkeypatch.setattr(subprocess, "Popen", no_subprocess)
    for k in KERNELS:
        monkeypatch.setattr(k, "launches", 0)
    cfg = wt.SageTrainConfig(n_nodes=50, dim=8, hidden=8, num_classes=3, batch=4, fanouts=(2, 2))
    c = torch.arange(4, dtype=torch.int32)
    for ratio in (None, 0.5):  # device-memory and host-tier embedding (kernels E and F)
        state = wt.build_synthetic(cfg, device="cpu", seed=0, host_cache_ratio=ratio)
        assert np.isfinite(float(wt.train_step(state, c, state.labels[c.long()], seed=0)))
    assert isinstance(state.embedding, HostEmbedding)
    # full-graph SAGE and GAT, forward and backward (kernels A, G and H)
    for model_type in ("sage", "gat"):
        fcfg = wt.FullGraphConfig(n_nodes=60, deg=4, width=8, dim=8, hidden=8, num_classes=3,
                                  model_type=model_type, num_heads=2)
        fs = wt.build_full_graph(fcfg, device="cpu")
        x = fs.embedding.gather(torch.arange(60, dtype=torch.int32))
        loss, (grads, dx) = wt.full_graph_value_and_grad(fs.model, x, fs.fg, c, fs.labels[:4])
        assert np.isfinite(float(loss)) and torch.isfinite(dx).all()
        assert np.isfinite(float(wt.eval_full_graph(fs.model, fs.embedding, fs.fg, c,
                                                    fs.labels[:4])[0]))
    # the sharded store: both gather routes, their gradient, set and add (kernels I, J, B)
    table = wt.ShardedTable.create(30, 4, init=lambda g, shape, dt: torch.randn(shape, generator=g),
                                   device="cpu")
    ids = torch.tensor([3, 1, 29, 30, -1], dtype=torch.int32)
    for lk in ("ring", "sorted"):
        data = table.data.clone().requires_grad_()
        wt.ops.gather.gather(data, ids, plan=table.plan, local_kernel=lk).sum().backward()
        assert data.grad.sum() == 12.0
    table = table.scatter(ids, torch.ones(5, 4)).scatter(ids, torch.ones(5, 4), accumulate=True,
                                                          donate=True)
    assert torch.equal(table.gather(ids[:3]), torch.full((3, 4), 2.0))
    assert torch.equal(wt.ops.local_take_sorted(table.data, ids)[3:], table.data[[29, 0]])
    assert not kernels._libs
    assert all(k.launches == 0 and not k.routes for k in KERNELS)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(kernels, "find_nvcc", lambda: None)
    with pytest.raises(CudaError, match="nvcc not found"):
        kernels.build_all()
    assert not os.listdir(tmp_path)
    # every source carries at least one Kernel, and every Kernel a source
    assert sorted({os.path.join(kernels.CSRC, k.source) for k in KERNELS}) == kernels.sources()
    assert len({k.entry for k in KERNELS}) == len(KERNELS)


def test_wrappers_do_not_fall_back_off_the_cpu():
    """A tensor on a device other than the CPU never reaches a plain version."""
    meta = torch.empty(16, 8, device="meta")
    ids = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(CudaError):
        G.gather_rows(meta, ids)
    with pytest.raises(CudaError):
        G.gather_rows(torch.zeros(16, 8), ids)  # a CPU/other mix
    with pytest.raises(CudaError):
        S.neighbor_reduce(meta, torch.zeros(2, 3, dtype=torch.int32, device="meta"),
                          torch.ones(2, 3, dtype=torch.bool, device="meta"), True)
    with pytest.raises(CudaError):
        H.host_gather_rows(torch.zeros(16, 8), ids)  # a host table with slots off the CPU
    row_ptr = torch.tensor([0, 2, 4, 4, 4], dtype=torch.int32)
    col = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(CudaError):
        S.csr_spmm(row_ptr.to("meta"), col.to("meta"), meta, reduce="mean")
    with pytest.raises(CudaError):
        S.csr_spmm(row_ptr, col, meta)  # a CPU CSR over features off the CPU
    with pytest.raises(CudaError):
        S.csr_sddmm(row_ptr.to("meta"), col.to("meta"), meta[:4], meta)
    with pytest.raises(CudaError):
        H.host_scatter_rows(torch.zeros(16, 8), ids, torch.zeros(4, 8, device="meta"))
    # the store's kernels: I, J and B's masked route
    for fn in (G.gather_rows_sorted, G.gather_rows_masked):
        with pytest.raises(CudaError):
            fn(meta, ids)
        with pytest.raises(CudaError):
            fn(torch.zeros(16, 8), ids)
    with pytest.raises(CudaError):
        G.scatter_rows_masked(torch.zeros(16, 8), ids, torch.zeros(4, 8, device="meta"))


def test_library_path_tracks_the_source(tmp_path, monkeypatch):
    src = tmp_path / "k.cu"
    src.write_text("// a")
    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path / "_build"))
    p1 = kernels.library_path(str(src))
    src.write_text("// b")
    p2 = kernels.library_path(str(src))
    assert p1 != p2 and os.path.basename(p1).startswith("libk-")


def test_library_path_tracks_the_headers(tmp_path):
    """A header beside the sources (kernel B's body, shared with kernel F)
    is part of every library's hash."""
    src, hdr = tmp_path / "k.cu", tmp_path / "body.cuh"
    src.write_text('#include "body.cuh"')
    hdr.write_text("// a")
    p1 = kernels.library_path(str(src))
    hdr.write_text("// b")
    assert kernels.library_path(str(src)) != p1
    assert os.path.exists(os.path.join(kernels.CSRC, "row_scatter.cuh"))
    assert all("#include \"row_scatter.cuh\"" in open(os.path.join(kernels.CSRC, s)).read()
               for s in (G.ROW_SCATTER.source, H.HOST_SCATTER.source))
