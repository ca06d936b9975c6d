"""Typed node feature spaces (heterogeneous nodes), one device.

Port of ``wholegraph_tpu/graph/hetero.py`` at world 1. MAG240M-style graphs
carry several node types (paper, author, institution) with per-type feature
tables of different widths, under one id space partitioned by type:
``gid = offset[type] + local_id`` (the OGB hetero convention).

* :class:`NodeTypeSpace` holds the layout and maps ids both ways.
* :class:`HeteroFeatureStore` holds one :class:`~wholegraph_tpu_torch.
  embedding.Embedding` a type. A mixed batch gathers from every type's
  table with the whole batch, off-type slots reading row 0 and zeroed
  (:meth:`~HeteroFeatureStore.gather_typed`); the per-type sparse update
  (:meth:`~HeteroFeatureStore.apply_gradients`) masks them out, so they
  never touch a type's table or optimizer state. As the port's
  ``Embedding`` does, the store owns its tensors and updates them in
  place: the JAX package's functional ``states`` argument goes.
* :func:`build_hetero_graph` and :func:`synthetic_hetero_dataset` build the
  typed-edge graph and the miniature MAG240M-shaped task, numpy only and
  bit-equal to the JAX package's for the same seed.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from ..embedding.embedding import Embedding
from ..embedding.optimizers import SparseOptimizer
from ..utils.device import DeviceLike, resolve_device
from ..utils.error import check_input


@dataclasses.dataclass(frozen=True)
class NodeTypeSpace:
    """Static type layout: names, row counts, feature dims, id offsets."""

    names: tuple
    counts: tuple
    dims: tuple

    @staticmethod
    def create(counts: Mapping[str, int], dims: Mapping[str, int]) -> "NodeTypeSpace":
        names = tuple(counts)
        check_input(set(dims) == set(names), "dims/counts type mismatch")
        return NodeTypeSpace(names=names, counts=tuple(int(counts[n]) for n in names),
                             dims=tuple(int(dims[n]) for n in names))

    @property
    def offsets(self) -> np.ndarray:
        """offsets[t] = first global id of type t; offsets[-1] = total."""
        return np.concatenate([[0], np.cumsum(self.counts)]).astype(np.int64)

    @property
    def total(self) -> int:
        return int(sum(self.counts))

    def _offsets(self, ids: torch.Tensor, sl: slice) -> torch.Tensor:
        return torch.from_numpy(self.offsets[sl]).to(device=ids.device, dtype=ids.dtype)

    def type_of(self, gids: torch.Tensor) -> torch.Tensor:
        """Type index of each global id, int32 (ids past the last type map
        to it, negative ones to the first; callers mask)."""
        return torch.searchsorted(self._offsets(gids, slice(1, -1)), gids, right=True,
                                  out_int32=True)

    def local_of(self, gids: torch.Tensor) -> torch.Tensor:
        return gids - self._offsets(gids, slice(None, -1))[self.type_of(gids).long()]

    def global_of(self, name: str, local_ids: torch.Tensor) -> torch.Tensor:
        return local_ids + int(self.offsets[self.names.index(name)])


@dataclasses.dataclass(frozen=True)
class HeteroFeatureStore:
    """One (optionally trainable) :class:`Embedding` a node type."""

    space: NodeTypeSpace
    embeddings: Dict[str, Embedding]

    @staticmethod
    def create(space: NodeTypeSpace, *, optimizer: Optional[SparseOptimizer] = None,
               dtype="float32", device: DeviceLike = "cuda") -> "HeteroFeatureStore":
        """Zero tables of each type's count and width on ``device``, each
        with ``optimizer``'s slots."""
        dev = resolve_device(device)
        return HeteroFeatureStore(space, {
            n: Embedding.create(c, d, optimizer=optimizer, dtype=dtype, device=dev)
            for n, c, d in zip(space.names, space.counts, space.dims)})

    def init(self, generator: torch.Generator) -> "HeteroFeatureStore":
        """Scaled-normal tables, drawn from ``generator`` type by type."""
        for n in self.space.names:
            self.embeddings[n].init(generator)
        return self

    def from_arrays(self, arrays: Mapping[str, np.ndarray]) -> "HeteroFeatureStore":
        check_input(set(arrays) == set(self.space.names), "array/type mismatch")
        for n in self.space.names:
            self.embeddings[n].from_array(arrays[n])
        return self

    def _type_masks(self, gids: torch.Tensor):
        """Each slot's local id, and each type's mask of the slots that
        hold one of its ids."""
        t = self.space.type_of(gids)
        loc = self.space.local_of(gids)
        ok = (gids >= 0) & (gids < self.space.total)
        return loc, {n: (t == i) & ok for i, n in enumerate(self.space.names)}

    def gather_typed(self, gids: torch.Tensor):
        """``(rows_by_type, masks_by_type)``: each type's rows [B, dim_t]
        (kernel A on the card), zero on slots of other types and on ids
        outside the space, and its mask [B]. Take the gradient with respect
        to the rows and hand it to :meth:`apply_gradients`."""
        loc, masks = self._type_masks(gids)
        rows = {}
        for n, m in masks.items():
            r = self.embeddings[n].gather(torch.where(m, loc, 0).to(torch.int32))
            rows[n] = torch.where(m[:, None], r, 0.0)
        return rows, masks

    def apply_gradients(self, gids: torch.Tensor, grads_by_type: Mapping[str, torch.Tensor],
                        lr: float, *, mask: Optional[torch.Tensor] = None,
                        **kw) -> "HeteroFeatureStore":
        """Each type's sparse optimizer step on its slots of ``gids``, in
        place; off-type slots, ids outside the space and slots ``mask``
        leaves out touch neither the table nor the optimizer state (row 0
        included: the sampler-padding contract). ``kw`` goes to each
        :meth:`Embedding.apply_gradients` (``assume_unique=True`` where the
        caller's ids are unique)."""
        loc, masks = self._type_masks(gids)
        for n, m in masks.items():
            if mask is not None:
                m = m & mask
            self.embeddings[n].apply_gradients(torch.where(m, loc, 0).to(torch.int32),
                                               grads_by_type[n], lr, mask=m, **kw)
        return self


# ---------------------------------------------------------------------------
# Typed-edge graph construction and a synthetic MAG240M-style task
# ---------------------------------------------------------------------------


def build_hetero_graph(space: NodeTypeSpace, edges: Mapping[tuple, tuple], *,
                       add_reverse_relations: bool = False, device: DeviceLike = "cuda"):
    """One :class:`~wholegraph_tpu_torch.graph.GraphStructure` on ``device``
    from per-relation typed edge lists (``hetero.py:170-233``).

    ``edges`` maps ``(src_type, relation_name, dst_type)`` to ``(src_local,
    dst_local)`` numpy arrays; local ids are lifted into the unified id space
    and each relation gets a dense id (iteration order). With
    ``add_reverse_relations`` every relation ``r`` also emits a reverse
    relation ``len(edges) + r`` with source and destination swapped.
    Returns ``(graph, relation_names)``; ``graph.edge_type`` holds each
    edge's relation id."""
    from .structure import GraphStructure

    srcs, dsts, rels, names = [], [], [], []
    for rid, ((st, rname, dt), (s_loc, d_loc)) in enumerate(edges.items()):
        si, di = space.names.index(st), space.names.index(dt)
        s_arr, d_arr = np.asarray(s_loc), np.asarray(d_loc)
        check_input(len(s_arr) == len(d_arr),
                    f"relation {rname}: src/dst length mismatch ({len(s_arr)} vs {len(d_arr)})")
        check_input((s_arr >= 0).all() and (d_arr >= 0).all() and (s_arr < space.counts[si]).all()
                    and (d_arr < space.counts[di]).all(),
                    f"relation {rname}: local ids out of range")
        srcs.append(s_arr.astype(np.int64) + space.offsets[si])
        dsts.append(d_arr.astype(np.int64) + space.offsets[di])
        rels.append(np.full(len(s_arr), rid, np.int64))
        names.append(rname)
    R = len(names)
    if add_reverse_relations:
        for rid in range(R):
            srcs.append(dsts[rid])
            dsts.append(srcs[rid])
            rels.append(np.full(len(srcs[rid]), R + rid, np.int64))
            names.append(f"rev_{names[rid]}")
    g = GraphStructure.from_coo(np.concatenate(srcs), np.concatenate(dsts), space.total,
                                edge_type=np.concatenate(rels), num_relations=len(names),
                                device=device)
    return g, names


def synthetic_hetero_dataset(n_paper: int = 4000, n_author: int = 1500, n_inst: int = 200,
                             num_classes: int = 8, dims: Optional[Mapping[str, int]] = None,
                             papers_per_author: int = 4, cites_per_paper: int = 8,
                             homophily: float = 0.8, seed: int = 0,
                             device: DeviceLike = "cuda"):
    """Miniature MAG240M-shaped task (``hetero.py:236-328``): papers carry
    class labels and cite same-class papers with probability
    ``homophily``; authors write papers mostly from one class's pool;
    institutions collect authors. Papers carry a weak class signal in their
    features, authors a strong one. The numpy draws are the JAX package's,
    in its order, so the same seed gives the same arrays bit for bit.

    Returns a dict: ``space``, ``features`` (per-type numpy arrays),
    ``graph`` (the typed-edge :class:`GraphStructure` on ``device``),
    ``relations``, ``labels`` (papers), and ``train``/``valid``/``test``
    splits of paper local ids."""
    rs = np.random.RandomState(seed)
    dims = dict(dims or {"paper": 48, "author": 32, "inst": 16})
    space = NodeTypeSpace.create(counts={"paper": n_paper, "author": n_author, "inst": n_inst},
                                 dims=dims)
    labels = rs.randint(0, num_classes, n_paper)
    pools = [np.where(labels == c)[0] for c in range(num_classes)]
    pools = [p if len(p) else np.array([0]) for p in pools]

    # citations: homophilous paper -> paper
    src_p = np.repeat(np.arange(n_paper), cites_per_paper)
    same = rs.rand(len(src_p)) < homophily
    dst_p = rs.randint(0, n_paper, len(src_p))
    for c in range(num_classes):
        m = same & (labels[src_p] == c)
        dst_p[m] = pools[c][rs.randint(0, len(pools[c]), m.sum())]

    # authors: each has a home class and writes papers mostly from its pool
    author_class = rs.randint(0, num_classes, n_author)
    a_src = np.repeat(np.arange(n_author), papers_per_author)
    own = rs.rand(len(a_src)) < homophily
    a_dst = rs.randint(0, n_paper, len(a_src))
    for c in range(num_classes):
        m = own & (author_class[a_src] == c)
        a_dst[m] = pools[c][rs.randint(0, len(pools[c]), m.sum())]

    # affiliations: author -> institution
    i_src = np.arange(n_author)
    i_dst = rs.randint(0, n_inst, n_author)

    graph, rel_names = build_hetero_graph(
        space,
        {("paper", "cites", "paper"): (src_p, dst_p),
         ("author", "writes", "paper"): (a_src, a_dst),
         ("author", "affiliated", "inst"): (i_src, i_dst)},
        add_reverse_relations=True, device=device)

    def class_signal(cls, dim, scale):
        sig = np.zeros((len(cls), dim), np.float32)
        sig[np.arange(len(cls)), np.asarray(cls) % dim] = scale
        return sig

    features = {
        "paper": (class_signal(labels, dims["paper"], 0.8)
                  + rs.randn(n_paper, dims["paper"]).astype(np.float32)),
        "author": (class_signal(author_class, dims["author"], 2.0)
                   + 0.5 * rs.randn(n_author, dims["author"]).astype(np.float32)),
        "inst": rs.randn(n_inst, dims["inst"]).astype(np.float32) * 0.1,
    }

    perm = rs.permutation(n_paper)
    n_tr, n_va = int(n_paper * 0.6), int(n_paper * 0.2)
    return {"space": space, "features": features, "graph": graph, "relations": rel_names,
            "labels": labels, "train": perm[:n_tr], "valid": perm[n_tr:n_tr + n_va],
            "test": perm[n_tr + n_va:]}
