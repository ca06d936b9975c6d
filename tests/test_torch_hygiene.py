"""Hygiene of the port: it imports nothing of JAX or the JAX package, its
entry points refuse to fall back to the CPU when CUDA is missing, and its
kernel module imports and runs the CPU path without building anything."""

import ast
import glob
import os
import re
import subprocess

import numpy as np
import pytest
import torch

import wholegraph_tpu_torch as wt
from wholegraph_tpu_torch import kernels
from wholegraph_tpu_torch.embedding import Embedding, HostEmbedding
from wholegraph_tpu_torch.examples import hetero_node_classification as ex_het
from wholegraph_tpu_torch.examples import link_prediction as ex_lp
from wholegraph_tpu_torch.examples import node_classification as ex_nc
from wholegraph_tpu_torch.graph import GraphStructure
from wholegraph_tpu_torch.models import HomoGNN
from wholegraph_tpu_torch.ops import KERNELS
from wholegraph_tpu_torch.ops import gather_kernels as G
from wholegraph_tpu_torch.ops import host_kernels as H
from wholegraph_tpu_torch.ops import sampling as SM
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
                                   "sharded_table_host", "weighted_graph",
                                   "build_synthetic_weighted", "entry", "rgcn_model",
                                   "build_synthetic_rgcn", "typed_graph", "hetero_store",
                                   "hetero_model", "hetero_dataset", "build_hetero",
                                   "load_filelist", "sharded_table_from_filelist",
                                   "embedding_from_filelist", "load_embedding",
                                   "load_table_checkpoint", "load_host_embedding",
                                   "node_classification", "link_prediction",
                                   "hetero_node_classification", "parallel_init",
                                   "multiprocess_run", "dryrun_multichip",
                                   "build_synthetic_world", "partition_graph",
                                   "host_embedding_world", "build_synthetic_host_tier_world",
                                   "hetero_store_world", "build_hetero_world",
                                   "touch_counter_world", "load_host_embedding_world"])
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
        "weighted_graph": lambda: GraphStructure.from_coo(np.array([0, 1]), np.array([1, 0]), 2,
                                                          edge_weight=np.ones(2)),
        "build_synthetic_weighted": lambda: wt.build_synthetic(
            wt.SageTrainConfig(n_nodes=10, sample_method="weighted")),
        "entry": lambda: wt.entry.entry(),
        "rgcn_model": lambda: HomoGNN(8, 8, 2, model_type="rgcn", num_relations=2),
        "build_synthetic_rgcn": lambda: wt.build_synthetic(
            wt.SageTrainConfig(n_nodes=10, model_type="rgcn")),
        "typed_graph": lambda: GraphStructure.from_coo(np.array([0, 1]), np.array([1, 0]), 2,
                                                       edge_type=np.array([0, 1])),
        "hetero_store": lambda: wt.graph.HeteroFeatureStore.create(
            wt.graph.NodeTypeSpace.create({"a": 3}, {"a": 2})),
        "hetero_model": lambda: wt.models.HeteroGNN({"a": 2}, 8, 2, num_relations=2),
        "hetero_dataset": lambda: wt.graph.synthetic_hetero_dataset(40, 10, 5),
        "build_hetero": lambda: wt.build_hetero(wt.HeteroTrainConfig(n_paper=40, n_author=10,
                                                                     n_inst=5)),
        # file IO, checkpoints and the examples (their main without --device)
        "load_filelist": lambda: wt.io.load_filelist(["x.bin"], 4, "float32"),
        "sharded_table_from_filelist": lambda: wt.ShardedTable.from_filelist(["x.bin"], 4,
                                                                             "float32"),
        "embedding_from_filelist": lambda: Embedding.from_filelist(["x.bin"], 4),
        "load_embedding": lambda: wt.io.load_embedding("ckpt", "e"),
        "load_table_checkpoint": lambda: wt.io.load_table_checkpoint("ckpt", "t"),
        "load_host_embedding": lambda: wt.io.load_host_embedding("ckpt", "h"),
        "node_classification": lambda: ex_nc.main(["--smoke"]),
        "link_prediction": lambda: ex_lp.main(["--smoke"]),
        "hetero_node_classification": lambda: ex_het.main(["--smoke"]),
        # the ranks of world W: their bootstrap, spawner, dry run and state
        "parallel_init": lambda: wt.parallel.init(),
        "multiprocess_run": lambda: wt.parallel.multiprocess_run(2, print),
        "dryrun_multichip": lambda: wt.entry.dryrun_multichip(2, backend="gloo"),
        "build_synthetic_world": lambda: wt.build_synthetic(
            wt.SageTrainConfig(n_nodes=10), mesh=wt.parallel.create_global_mesh()),
        # the halo layout of a graph on the CPU, built for the default device
        "partition_graph": lambda: wt.graph.partition_graph(
            GraphStructure(torch.tensor([0, 1, 2], dtype=torch.int32),
                           torch.tensor([1, 0], dtype=torch.int32), 2)),
        # the host tier, the typed-node store and the touch counter over ranks
        "host_embedding_world": lambda: HostEmbedding.create(
            10, 4, mesh=wt.parallel.create_global_mesh()),
        "build_synthetic_host_tier_world": lambda: wt.build_synthetic(
            wt.SageTrainConfig(n_nodes=10), host_cache_ratio=0.25,
            mesh=wt.parallel.create_global_mesh()),
        "hetero_store_world": lambda: wt.graph.HeteroFeatureStore.create(
            wt.graph.NodeTypeSpace.create({"a": 3}, {"a": 2}),
            mesh=wt.parallel.create_global_mesh()),
        "build_hetero_world": lambda: wt.build_hetero(
            wt.HeteroTrainConfig(n_paper=40, n_author=10, n_inst=5),
            mesh=wt.parallel.create_global_mesh()),
        "touch_counter_world": lambda: wt.embedding.make_touch_counter(
            10, mesh=wt.parallel.create_global_mesh()),
        "load_host_embedding_world": lambda: wt.io.load_host_embedding(
            "ckpt", "h", mesh=wt.parallel.create_global_mesh()),
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
    # the weighted sampler (kernel K), a windowed plan (kernel D) and unique_chunk
    import dataclasses
    state = wt.build_synthetic(dataclasses.replace(cfg, sample_method="weighted"), device="cpu")
    assert np.isfinite(float(wt.train_step(state, c, state.labels[c.long()], seed=0)))
    ml = state.graph.multilayer_sample(c, cfg.fanouts, weighted=True).with_windowed_agg()
    rows = state.embedding.gather(ml.unique_gids)
    assert torch.isfinite(state.model(rows, ml)).all()
    state.embedding.apply_gradients(ml.unique_gids, torch.ones_like(rows), 0.1,
                                    mask=ml.unique_mask, unique_chunk=1024)
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
    # the sampled GCN (both degree modes), GAT and RGCN steps, and the hetero step (A-D)
    for mt, dm in (("gcn", "block"), ("gcn", "true"), ("gat", "auto"), ("rgcn", "auto")):
        state = wt.build_synthetic(dataclasses.replace(cfg, model_type=mt, degree_mode=dm,
                                                       num_heads=2), device="cpu")
        assert np.isfinite(float(wt.train_step(state, c, state.labels[c.long()], seed=0)))
    hs = wt.build_hetero(wt.HeteroTrainConfig(n_paper=40, n_author=10, n_inst=5, num_classes=3,
                                              hidden=8, batch=4, fanouts=(2, 2)), device="cpu")
    hc = hs.train_ids[:4]
    assert np.isfinite(float(wt.hetero_train_step(hs, hc, hs.labels[hc.long()], seed=0)))
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
    # kernel K, both routes, and its entry point
    w = torch.ones(4)
    pairs = SM.interleave_col_weights(col, w)
    for args in ((row_ptr.to("meta"), col.to("meta"), w.to("meta"), ids, 2, 0, 0),
                 (row_ptr, col, w, ids, 2, 0, 0)):
        with pytest.raises(CudaError):
            SM.sample_hop_weighted(*args)
    with pytest.raises(CudaError):
        SM.sample_hop_weighted(row_ptr.to("meta"), None, None, ids, 2, 0, 0,
                               pairs=pairs.to("meta"))
    with pytest.raises(CudaError):
        SM.csr_sample_neighbors(row_ptr, col, ids, 2, weights=w, max_degree=2,
                                cw_blocks=pairs.to("meta"))


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


def test_kernel_helpers_are_defined_once():
    """The copies into shared memory, the window rule of kernels G and H,
    the direct drain of kernels I and J and the device address of a mapped
    host tensor (kernels E, F and L's host route) each have one definition
    in ``csrc/``, and every kernel that uses one includes its header."""
    texts = {os.path.basename(p): open(p).read()
             for p in glob.glob(os.path.join(kernels.CSRC, "*.cu*"))}
    for pattern, home in ((r"void copy_to_shared\(", "async_copy.cuh"),
                          (r"MAX_DYNAMIC_SMEM =", "async_copy.cuh"),
                          (r"bool tile_staged\(", "csr_tiles.cuh"),
                          (r"void drain\(", "direct_gather.cuh"),
                          (r"cudaError_t device_address\(", "host_address.cuh")):
        assert [n for n, t in texts.items() if re.search(pattern, t)] == [home], pattern
    assert '#include "async_copy.cuh"' in texts["csr_tiles.cuh"]
    for src, header in (("sorted_gather.cu", "async_copy.cuh"),
                        ("sorted_gather.cu", "direct_gather.cuh"),
                        ("row_gather.cu", "direct_gather.cuh"),
                        ("csr_spmm.cu", "csr_tiles.cuh"), ("csr_sddmm.cu", "csr_tiles.cuh"),
                        ("host_rows.cu", "host_address.cuh"),
                        ("sparse_apply.cu", "host_address.cuh")):
        assert f'#include "{header}"' in texts[src], (src, header)


@pytest.mark.parametrize("part", ["A", "B", "D", "G", "J", "K", "L"])
def test_kernel_variants_still_apply_to_the_sources(part):
    """Every design alternative of ``tools/kernel_variants.py`` still
    matches the current source it edits (the tool lists a stale one and
    builds nothing of it, so its record would quietly shrink)."""
    from wholegraph_tpu_torch.tools import kernel_variants as kv

    def read(name):
        with open(os.path.join(kernels.CSRC, name)) as f:
            return f.read()

    built, stale = {
        "A": lambda: kv.a_variants(read("row_gather.cu")),
        "B": lambda: kv.b_variants(read("row_scatter.cu"), read("row_scatter.cuh")),
        "D": lambda: kv.d_variants(read("neighbor_agg.cu")),
        "G": lambda: kv.g_variants(read("csr_spmm.cu")),
        "J": lambda: kv.j_variants(read("row_gather.cu"), read("direct_gather.cuh")),
        "K": lambda: kv.k_register_variants(read("sample_weighted.cu")),
        "L": lambda: kv.l_variants(read("sparse_apply.cu")),
    }[part]()
    assert built and stale == []
