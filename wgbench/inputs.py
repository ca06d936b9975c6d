"""What a run of the ``homogeneous`` build is given (:func:`make_all`, its
``make_inputs``), made on the device from ``--seed``: the graph, the node
features, labels and splits, and the model's weights; and the seeds of
every stream of draws, which any build may use.

The benchmark makes these and hands the same to the port and to the plain
reference; each is drawn from a generator of its own, so any one of them
can be made again alone (the reference makes them again once the port's
state is freed). Only ``torch`` is imported here.

The graph is Chung-Lu (Chung and Lu 2002): ``undirected_edges`` edges whose
two endpoints are drawn independently with probability proportional to
``w_i = (i + i0)^(-1 / (exponent - 1))``, with ``i0`` set so that node 0's
expected degree is ``max_expected_degree``; node ids are then permuted at
random, the edges stored both ways in a CSR with int32 offsets, self loops
and duplicate edges kept. The graph and the splits are drawn alike for
every seed, as a dataset is one graph: the seed changes the features,
labels, weights and traffic, and not the work a pass over the graph costs
(a numbering drawn per seed moved the full-graph pass's time by 1-2 %).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

_MASK64 = (1 << 64) - 1

# one stream of draws a part, so that each part can be made again alone
STREAMS = {"graph": 1, "features": 2, "labels": 3, "weights": 4, "traffic": 5}


def mix64(x: int) -> int:
    """splitmix64's finalizer: a well-mixed 64-bit value of ``x``."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def derive(seed: int, *keys: int) -> int:
    """A 63-bit seed for a generator, from the run's seed and ``keys``."""
    h = mix64(int(seed) & _MASK64)
    for k in keys:
        h = mix64(h ^ (int(k) & _MASK64))
    return h >> 1


def generator(seed: int, stream: str, device, *keys: int) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(derive(seed, STREAMS[stream], *keys))
    return gen


def chung_lu_offset(n: int, undirected_edges: int, exponent: float,
                    max_expected_degree: float) -> float:
    """``i0`` such that node 0's expected degree is ``max_expected_degree``
    (bisection in float64 on the host's CPU; a few ms at 2.5M nodes)."""
    a = 1.0 / (exponent - 1.0)
    i = torch.arange(n, dtype=torch.float64)
    target = max_expected_degree / (2.0 * undirected_edges)
    lo, hi = 1e-6, 1e9
    for _ in range(100):
        mid = math.sqrt(lo * hi)
        w = (i + mid).pow(-a)
        if float(w[0] / w.sum()) > target:
            lo = mid
        else:
            hi = mid
    return math.sqrt(lo * hi)


def expected_degrees(n: int, undirected_edges: int, exponent: float, i0: float) -> torch.Tensor:
    """Each node's expected degree before the id permutation, float64."""
    w = (torch.arange(n, dtype=torch.float64) + i0).pow(-1.0 / (exponent - 1.0))
    return 2.0 * undirected_edges * w / w.sum()


def make_graph(cfg: Dict, seed: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(row_ptr [n+1] int32, col [2E] int32)`` of the configuration's
    graph on ``device``."""
    g = cfg["graph"]
    n, e = int(cfg["nodes"]), int(cfg["undirected_edges"])
    dev = torch.device(device)
    i0 = chung_lu_offset(n, e, g["degree_exponent"], g["max_expected_degree"])
    w = (torch.arange(n, dtype=torch.float64, device=dev) + i0).pow(-1.0 / (g["degree_exponent"] - 1.0))
    cdf = torch.cumsum(w / w.sum(), 0)
    del w
    gen = generator(0, "graph", dev)  # alike for every seed: the dataset
    perm = torch.randperm(n, generator=gen, device=dev).to(torch.int32)  # ids in random order
    ends = []
    for _ in range(2):
        u = torch.rand(e, generator=gen, device=dev, dtype=torch.float64)
        ends.append(perm[torch.searchsorted(cdf, u, right=True).clamp_(max=n - 1)])
        del u
    del cdf
    src = torch.cat([ends[0], ends[1]])
    dst = torch.cat([ends[1], ends[0]])
    del ends
    src_sorted, order = torch.sort(src, stable=True)
    col = dst[order]
    del dst, order
    counts = torch.bincount(src_sorted, minlength=n)
    del src, src_sorted
    row_ptr = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    torch.cumsum(counts, 0, out=row_ptr[1:])
    return row_ptr.to(torch.int32), col


def make_features(cfg: Dict, seed: int, device) -> torch.Tensor:
    """``[n, feat_dim]`` float32 features, standard normal."""
    gen = generator(seed, "features", device)
    return torch.randn((int(cfg["nodes"]), int(cfg["feat_dim"])), generator=gen,
                       device=torch.device(device), dtype=torch.float32)


def make_labels_and_splits(cfg: Dict, seed: int, device) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Labels ``[n]`` int32 in ``[0, num_classes)``, drawn from the seed,
    and the splits, node ids int32: one permutation drawn alike for every
    seed, cut in the configuration's sizes in the order ``splits`` lists
    them."""
    n = int(cfg["nodes"])
    dev = torch.device(device)
    gen = generator(seed, "labels", dev)
    labels = torch.randint(0, int(cfg["num_classes"]), (n,), generator=gen, device=dev,
                           dtype=torch.int32)
    perm = torch.randperm(n, generator=generator(0, "labels", dev), device=dev).to(torch.int32)
    splits, at = {}, 0
    for name, size in cfg["splits"].items():
        splits[name] = perm[at:at + int(size)]
        at += int(size)
    return labels, splits


def layer_dims(cfg: Dict) -> List[Tuple[int, int]]:
    """``(in, out)`` of every layer: feat_dim, hidden ..., num_classes."""
    dims = [int(cfg["feat_dim"])] + [int(cfg["hidden"])] * (int(cfg["num_layers"]) - 1) \
        + [int(cfg["num_classes"])]
    return list(zip(dims[:-1], dims[1:]))


def layer_heads(cfg: Dict) -> List[int]:
    """Heads of every GAT layer: ``heads``, the last layer one."""
    L = int(cfg["num_layers"])
    return [int(cfg.get("heads", 1))] * (L - 1) + [1]


def make_weights(cfg: Dict, seed: int, device) -> List[Dict[str, torch.Tensor]]:
    """Every layer's weights, float32, in the layout of the plain model:

    - ``sage``: ``w`` [2 in, out] over ``[self, mean of neighbours]``, ~ N(0, 1/(2 in)),
      and ``b`` [out], zero;
    - ``gat``: ``w`` [in, heads * out/heads] ~ N(0, 1/in), ``attn_src`` and
      ``attn_dst`` [heads, out/heads] ~ U(-l, l), l = sqrt(6 / (heads + out/heads)).
    """
    gen = generator(seed, "weights", device)
    dev = torch.device(device)
    out = []
    for (din, dout), heads in zip(layer_dims(cfg), layer_heads(cfg)):
        if cfg["model"] == "sage":
            w = torch.randn((2 * din, dout), generator=gen, device=dev) / math.sqrt(2 * din)
            out.append({"w": w, "b": torch.zeros(dout, device=dev)})
        elif cfg["model"] == "gat":
            d = dout // heads
            w = torch.randn((din, heads * d), generator=gen, device=dev) / math.sqrt(din)
            lim = math.sqrt(6.0 / (heads + d))
            a_s = (2.0 * torch.rand((heads, d), generator=gen, device=dev) - 1.0) * lim
            a_d = (2.0 * torch.rand((heads, d), generator=gen, device=dev) - 1.0) * lim
            out.append({"w": w, "attn_src": a_s, "attn_dst": a_d})
        else:
            raise ValueError(f"unknown model {cfg['model']!r}")
    return out


def make_all(cfg: Dict, seed: int, device) -> Dict:
    """Every input of a run: the CSR, features, labels and splits, and the
    model's weights."""
    row_ptr, col = make_graph(cfg, seed, device)
    labels, splits = make_labels_and_splits(cfg, seed, device)
    return {"row_ptr": row_ptr, "col": col, "features": make_features(cfg, seed, device),
            "labels": labels, "splits": splits, "weights": make_weights(cfg, seed, device)}
