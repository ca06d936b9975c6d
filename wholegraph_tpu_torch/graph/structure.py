"""Graph structure and multi-layer mini-batch sampling.

Port of ``wholegraph_tpu/graph/structure.py``: :class:`HopSubgraph` (with
its edge types, true degrees and windowed-aggregation plan),
:class:`MultilayerSample` (``run_bounds``, ``with_windowed_agg``) and
:class:`GraphStructure` with ``from_coo`` (edge weights and edge types
included), ``with_weighted_fastpath``, ``to_full_graph``, ``sample_one_hop``
and ``multilayer_sample``, uniform or weighted, with or without the true
degrees.

The CSR's arrays are tensors on one device (replicated on every rank at
world W), or ShardedTables over the ranks (the JAX package's distributed
CSR, ``structure.py:141-175``): then every read of ``row_ptr``, ``col``,
``edge_weight`` and ``edge_type`` is the store's exact gather, every rank
samples its own centres (as many on every rank), and the sample is the
replicated graph's bit for bit.

Shape discipline is the JAX package's: every hop's output is padded. Layer
l has ``B * prod_{i<l}(K_i + 1)`` target slots; ``append_unique`` keeps the
targets as a prefix of the next level's unique list, so the unique node
sets nest and level l+1's activations give level l's self features by
slicing. Padding targets get the distinct dummy ids ``n + arange(U)``,
padded unique ids become the sentinel ``n``, and ``nbr_idx`` is 0 where
masked (``structure.py:340-386``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..ops.graph_ops import append_unique
from ..ops.sampling import (SampleResult, SeedLike, csr_sample_neighbors,
                             interleave_col_weights, is_table)
from ..utils import perf
from ..utils.device import DeviceLike, resolve_device
from ..utils.error import check_input


@dataclasses.dataclass
class HopSubgraph:
    """One sampled hop, in padded relabelled form.

    nbr_idx:     [B_l, K] int32 neighbour positions in the NEXT level's unique list.
    mask:        [B_l, K] edge validity.
    center_mask: [B_l] target-slot validity.
    edge_type:   [B_l, K] int32 relation ids (RGCN), 0 on masked slots; None
        when the graph has no edge types.
    node_degree: [U_{l+1}] int32 true graph degrees (``row_ptr`` diffs) of
        the NEXT level's unique nodes, 0 on padding; filled by
        ``multilayer_sample(with_degrees=True)`` for the sampled GCN's
        exact normalisation.
    run_bounds, windows: the windowed-aggregation plan
        (:meth:`MultilayerSample.with_windowed_agg`); a conv that finds it
        aggregates through ``padded_reduce_windowed``.
    """

    nbr_idx: torch.Tensor
    mask: torch.Tensor
    center_mask: torch.Tensor
    edge_type: Optional[torch.Tensor] = None
    node_degree: Optional[torch.Tensor] = None
    run_bounds: Optional[tuple] = None
    windows: Optional[tuple] = None

    @property
    def num_targets(self) -> int:
        return self.nbr_idx.shape[0]

    @property
    def fanout(self) -> int:
        return self.nbr_idx.shape[1]


@dataclasses.dataclass
class MultilayerSample:
    """Result of multi-layer sampling.

    hops[l] relabels level-l targets against level-(l+1) uniques;
    unique_gids/unique_mask describe the DEEPEST level's unique node set
    (padding slots hold the sentinel ``n`` and are masked).
    """

    hops: List[HopSubgraph]
    unique_gids: torch.Tensor
    unique_mask: torch.Tensor
    level_gids: List[torch.Tensor] = dataclasses.field(default_factory=list)
    level_masks: List[torch.Tensor] = dataclasses.field(default_factory=list)

    def run_bounds(self, level: int) -> tuple:
        """Run boundaries of the unique list of the hop-``level`` block
        (whose x rows are ``level_gids[level + 1]``): each level's unique
        list is [previous level's list | new ids ascending]
        (``append_unique``), so the boundaries are the level buffer sizes
        (``structure.py:109-117``)."""
        return (0,) + tuple(int(g.shape[0]) for g in self.level_gids[: level + 2])

    def with_windowed_agg(self, windows=2048) -> "MultilayerSample":
        """A copy whose every hop carries its windowed-aggregation plan: the
        run boundaries and per-run windows (``windows`` an int for every run,
        rounded up to 128 rows within the run's size, or a per-hop tuple of
        per-run tuples), as ``structure.py:119-137`` gives them."""
        hops = []
        for l, h in enumerate(self.hops):
            rb = self.run_bounds(l)
            if isinstance(windows, int):
                w = tuple(min(-(-min(b2 - b1, windows) // 128) * 128, windows)
                          for b1, b2 in zip(rb, rb[1:]))
            else:
                w = tuple(windows[l])
            hops.append(dataclasses.replace(h, run_bounds=rb, windows=w))
        return dataclasses.replace(self, hops=hops)


class GraphStructure:
    """CSR graph (torch/graph_structure.py:21 analog).

    ``row_ptr`` [N+1] and ``col`` [E] are int32 tensors on the graph's
    device; build one from device tensors directly or from a host COO list
    with :meth:`from_coo`. ``edge_weight`` [E] (float32) serves weighted
    sampling, which needs ``max_degree``: a weighted graph built without one
    reads it from ``row_ptr`` once. ``cw_blocks`` is the pair table of
    :meth:`with_weighted_fastpath`. ``edge_type`` [E] (int32) holds each
    edge's relation id for RGCN, ``num_relations`` their count.

    Any of ``row_ptr``, ``col``, ``edge_weight`` and ``edge_type`` may be a
    1-D :class:`~wholegraph_tpu_torch.memory.ShardedTable` instead (int32,
    the weights float32), sharded over the ranks: the sampler and every
    method then read it through the store (at world W every rank calls
    them together)."""

    def __init__(self, row_ptr, col, node_count: int, edge_count: Optional[int] = None,
                 max_degree: Optional[int] = None, edge_weight=None,
                 cw_blocks: Optional[torch.Tensor] = None, edge_type=None,
                 num_relations: int = 0):
        def rows(t):
            return t.n if is_table(t) else t.shape[0]

        for name, t in (("row_ptr", row_ptr), ("col", col), ("edge_weight", edge_weight),
                        ("edge_type", edge_type)):
            check_input(t is None or not is_table(t) or (t.dim == 0 and t.location == "device"),
                        f"a sharded {name} must be a 1-D table in device memory")
        check_input((is_table(row_ptr) or row_ptr.dim() == 1) and rows(row_ptr) == node_count + 1,
                    f"row_ptr must be [{node_count + 1}], got {rows(row_ptr)} rows")
        check_input(is_table(col) or col.dim() == 1, "col must be 1-D")
        check_input(row_ptr.device == col.device, "row_ptr and col on different devices")
        E = rows(col)
        check_input(E < 2**31, "edge offsets are int32: the graph must have < 2^31 edges")
        for name, t, shape in (("edge_weight", edge_weight, (E,)),
                               ("cw_blocks", cw_blocks, (E, 2)),
                               ("edge_type", edge_type, (E,))):
            check_input(t is None or ((rows(t),) if is_table(t) else tuple(t.shape)) == shape
                        and t.device == col.device,
                        f"{name} must be {shape} on the graph's device")
        for name, t in (("row_ptr", row_ptr), ("col", col), ("edge_type", edge_type)):
            check_input(t is None or not is_table(t) or t.dtype == torch.int32,
                        f"a sharded {name} must be int32")
        check_input(edge_weight is None or not is_table(edge_weight)
                    or edge_weight.dtype == torch.float32, "sharded edge weights must be float32")

        def keep(t, dtype):
            return t if t is None or is_table(t) else t.to(dtype)

        self.row_ptr = keep(row_ptr, torch.int32)
        self.col = keep(col, torch.int32)
        self.node_count = int(node_count)
        self.edge_count = int(E if edge_count is None else edge_count)
        self.edge_weight = keep(edge_weight, torch.float32)
        self.cw_blocks = cw_blocks
        self.edge_type = keep(edge_type, torch.int32)
        self.num_relations = int(num_relations)
        if max_degree is None and edge_weight is not None:
            max_degree = int(self.degrees().max()) if node_count else 0
        self.max_degree = max_degree

    @property
    def sharded(self) -> bool:
        """Whether any array of the CSR is a ShardedTable."""
        return any(is_table(t) for t in (self.row_ptr, self.col, self.edge_weight,
                                          self.edge_type))

    @staticmethod
    def _array(t) -> Optional[torch.Tensor]:
        """A CSR array whole on this device: the tensor, or a table's logical
        array read through the store (at world W a collective)."""
        if t is None or not is_table(t):
            return t
        return torch.from_numpy(t.to_array()).to(t.device)

    def degrees(self) -> torch.Tensor:
        """Every node's out-degree ``row_ptr[i + 1] - row_ptr[i]``, int32
        (a sharded ``row_ptr`` read through the store)."""
        rp = self._array(self.row_ptr)
        return (rp[1:] - rp[:-1]).to(torch.int32)

    @property
    def device(self) -> torch.device:
        return self.col.device

    def with_weighted_fastpath(self) -> "GraphStructure":
        """A copy carrying the pair table ``interleave_col_weights(col,
        edge_weight)`` ([E, 2] int32, E x 8 bytes more on the device):
        kernel K then reads an edge's weight and neighbour in one 8-byte
        load. The sample is the same bits either way. A sharded ``col`` or
        ``edge_weight`` is refused, as in JAX (``structure.py:166-170``):
        kernel K reads a CSR in device memory."""
        check_input(self.edge_weight is not None, "with_weighted_fastpath needs edge_weight")
        check_input(not is_table(self.col) and not is_table(self.edge_weight),
                    "the weighted fast path needs a replicated col and edge_weight, not "
                    "ShardedTables")
        return GraphStructure(self.row_ptr, self.col, self.node_count, self.edge_count,
                              self.max_degree, self.edge_weight,
                              interleave_col_weights(self.col, self.edge_weight),
                              self.edge_type, self.num_relations)

    @staticmethod
    def from_coo(src: np.ndarray, dst: np.ndarray, node_count: int, *,
                 edge_weight: Optional[np.ndarray] = None,
                 edge_type: Optional[np.ndarray] = None, num_relations: int = 0,
                 add_reverse: bool = False, device: DeviceLike = "cuda") -> "GraphStructure":
        """Host-side CSR build from a COO edge list, moved to ``device``;
        ``edge_weight`` and ``edge_type`` follow their edges (doubled with
        ``add_reverse``, permuted with the sort by source). A graph with
        edge types and ``num_relations=0`` counts ``max(edge_type) + 1``."""
        dev = resolve_device(device)
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        if add_reverse:
            src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
            if edge_weight is not None:
                edge_weight = np.concatenate([edge_weight, edge_weight])
            if edge_type is not None:
                edge_type = np.concatenate([edge_type, edge_type])
        order = np.argsort(src, kind="stable")
        src, dst = src[order], dst[order]
        weight = etype = None
        if edge_weight is not None:
            weight = torch.from_numpy(np.asarray(edge_weight)[order].astype(np.float32)).to(dev)
        if edge_type is not None:
            edge_type = np.asarray(edge_type)[order]
            if not num_relations:
                num_relations = int(edge_type.max()) + 1
            etype = torch.from_numpy(edge_type.astype(np.int32)).to(dev)
        counts = np.bincount(src, minlength=node_count)
        row_ptr = np.concatenate([[0], np.cumsum(counts)])
        return GraphStructure(
            torch.from_numpy(row_ptr.astype(np.int32)).to(dev),
            torch.from_numpy(dst.astype(np.int32)).to(dev),
            node_count,
            edge_count=len(dst),
            max_degree=int(counts.max()) if node_count else 0,
            edge_weight=weight,
            edge_type=etype,
            num_relations=num_relations,
        )

    def to_full_graph(self, *, windowed: bool = False, tile: int = 256):
        """The :class:`~wholegraph_tpu_torch.models.conv.FullGraph` of this
        CSR for exact full-graph passes (``structure.py:220-274``): messages
        flow col → row, ``edge_src = col``, ``edge_dst`` each edge's row,
        both on the graph's device, and the CSR itself as ``row_ptr``.

        ``windowed=True`` also runs ``plan_spmm_tiles`` (one host pass over
        the CSR) and records its ``window`` and ``edge_cap`` when the plan
        is feasible, None otherwise, as the JAX package does. Kernel G
        needs no plan, so the graph aggregates the same way either way. A
        sharded CSR is read whole through the store (at world W a
        collective: every rank gets the whole graph)."""
        from ..models.conv import FullGraph
        from ..ops.spmm import plan_spmm_tiles
        from ..ops.spmm_kernels import csr_edge_dst

        row_ptr, col = self._array(self.row_ptr), self._array(self.col)
        window = edge_cap = None
        if windowed:
            w, cap, feasible = plan_spmm_tiles(row_ptr.cpu().numpy(), col.cpu().numpy(), tile=tile)
            if feasible:
                window, edge_cap = int(w), int(cap)
        return FullGraph(
            edge_src=col,
            edge_dst=csr_edge_dst(row_ptr, col.shape[0]).to(torch.int32),
            num_nodes=self.node_count,
            edge_type=self._array(self.edge_type),
            row_ptr=row_ptr,
            window=window,
            edge_cap=edge_cap,
        )

    # -- sampling -------------------------------------------------------------

    def sample_one_hop(self, centers: torch.Tensor, max_sample: int, *, seed: SeedLike = 0,
                       hop: int = 0, weighted: bool = False,
                       gather_kwargs: Optional[dict] = None) -> SampleResult:
        """{un,}weighted_sample_without_replacement_one_hop analog
        (graph_structure.py:77-138). ``weighted`` samples by ``edge_weight``
        (through the pair table when the graph has one); as in the JAX
        package, a graph without weights samples uniformly either way.
        ``gather_kwargs`` go to the store's gathers of a sharded CSR."""
        return csr_sample_neighbors(
            self.row_ptr, self.col, centers, max_sample, seed=seed, hop=hop,
            weights=self.edge_weight if weighted else None, max_degree=self.max_degree,
            cw_blocks=self.cw_blocks if weighted else None, gather_kwargs=gather_kwargs)

    def multilayer_sample(self, centers: torch.Tensor, fanouts: Sequence[int], *,
                          seed: SeedLike = 0, weighted: bool = False,
                          center_mask: Optional[torch.Tensor] = None,
                          with_degrees: bool = False,
                          gather_kwargs: Optional[dict] = None) -> MultilayerSample:
        """multilayer_sample_without_replacement analog: per layer, sample
        (weighted or not) and ``append_unique``, producing nested padded
        subgraphs (``structure.py:303-395``).

        A graph with edge types puts each sampled edge's type on its hop
        (``HopSubgraph.edge_type``, 0 where masked). ``with_degrees=True``
        also puts the true degree ``row_ptr[u + 1] - row_ptr[u]`` of every
        valid unique id of the next level on the hop
        (``HopSubgraph.node_degree``, 0 on padding). Both are plain
        ``index_select``s, as they are plain ``jnp.take``s in JAX.

        Over a sharded CSR each of these reads is the store's exact gather
        (``gather_kwargs``), every rank passes as many centres, and the
        slots the sample leaves out are sent as -1, which travel nowhere
        (JAX sends id 0 for them, to the owner of row 0).

        ``seed`` may be a 0-dim integer tensor on the graph's device: every
        hop passes it on, and on the card kernels C and K read it there, so
        a CUDA graph of the step samples with each step's seed
        (:func:`~wholegraph_tpu_torch.train.train_epoch`).

        Its span is ``sample`` (``utils.perf.span``); each hop's
        ``append_unique`` is a span inside it."""
        with perf.span("sample"):
            n = self.node_count
            E = self.edge_count
            kw = gather_kwargs or {}
            off = -1 if self.sharded else 0  # the centre id of a padding slot
            gids = centers.to(torch.int32)
            gmask = (torch.ones(gids.shape, dtype=torch.bool, device=gids.device)
                     if center_mask is None else center_mask)
            hops: List[HopSubgraph] = []
            level_gids, level_masks = [gids], [gmask]
            for l, K in enumerate(fanouts):
                U = gids.shape[0]
                res = self.sample_one_hop(torch.where(gmask, gids, off), K, seed=seed, hop=l,
                                          weighted=weighted, gather_kwargs=gather_kwargs)
                emask = res.mask & gmask[:, None]
                # distinct dummy ids for padding targets keep their slots unique
                dummy = n + torch.arange(U, dtype=torch.int32, device=gids.device)
                tgt = torch.where(gmask, gids, dummy)
                nbrs = torch.where(emask, res.neighbors, 0).reshape(-1)
                uids, _, nmap = append_unique(tgt, nbrs, emask.reshape(-1))
                etypes = None
                if is_table(self.edge_type):
                    eids = torch.where(emask, res.edge_ids, -1).reshape(-1)
                    etypes = torch.where(emask, self.edge_type.gather(eids, **kw).reshape(U, K),
                                         0)
                elif self.edge_type is not None:  # clip, as JAX's take does, then zero where masked
                    eids = torch.where(emask, res.edge_ids, 0).reshape(-1).long().clamp(0, E - 1)
                    etypes = torch.where(emask,
                                         self.edge_type.index_select(0, eids).reshape(U, K), 0)
                next_mask = (uids >= 0) & (uids < n)
                node_degree = None
                if with_degrees and is_table(self.row_ptr):
                    lo = self.row_ptr.gather(torch.where(next_mask, uids, -1), **kw)
                    hi = self.row_ptr.gather(torch.where(next_mask, uids + 1, -1), **kw)
                    node_degree = torch.where(next_mask, hi - lo, 0).to(torch.int32)
                elif with_degrees:
                    safe = torch.where(next_mask, uids, 0).long()
                    deg = (self.row_ptr.index_select(0, safe + 1)
                           - self.row_ptr.index_select(0, safe))
                    node_degree = torch.where(next_mask, deg, 0).to(torch.int32)
                hops.append(HopSubgraph(
                    nbr_idx=torch.where(emask, nmap.reshape(U, K), 0),
                    mask=emask,
                    center_mask=gmask,
                    edge_type=etypes,
                    node_degree=node_degree,
                ))
                gmask = next_mask
                # padding → the out-of-range sentinel n; gathers clip it and the
                # apply's mask= keeps it away from the table and optimizer state
                gids = torch.where(gmask, uids, n)
                level_gids.append(gids)
                level_masks.append(gmask)
            return MultilayerSample(hops=hops, unique_gids=gids, unique_mask=gmask,
                                    level_gids=level_gids, level_masks=level_masks)
