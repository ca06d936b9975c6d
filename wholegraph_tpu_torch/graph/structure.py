"""Graph structure and multi-layer mini-batch sampling, one device.

Port of the unweighted, single-device part of
``wholegraph_tpu/graph/structure.py``: :class:`HopSubgraph`,
:class:`MultilayerSample` and :class:`GraphStructure` with ``from_coo``,
``to_full_graph``, ``sample_one_hop`` and ``multilayer_sample``.

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
from ..ops.sampling import SampleResult, csr_sample_neighbors
from ..utils.device import DeviceLike, resolve_device
from ..utils.error import check_input


@dataclasses.dataclass
class HopSubgraph:
    """One sampled hop, in padded relabelled form.

    nbr_idx:     [B_l, K] int32 neighbour positions in the NEXT level's unique list.
    mask:        [B_l, K] edge validity.
    center_mask: [B_l] target-slot validity.
    """

    nbr_idx: torch.Tensor
    mask: torch.Tensor
    center_mask: torch.Tensor

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


class GraphStructure:
    """CSR graph on one device (torch/graph_structure.py:21 analog).

    ``row_ptr`` [N+1] and ``col`` [E] are int32 tensors on the graph's
    device; build one from device tensors directly or from a host COO list
    with :meth:`from_coo`."""

    def __init__(self, row_ptr: torch.Tensor, col: torch.Tensor, node_count: int,
                 edge_count: Optional[int] = None, max_degree: Optional[int] = None):
        check_input(row_ptr.dim() == 1 and row_ptr.shape[0] == node_count + 1,
                    f"row_ptr must be [{node_count + 1}], got {tuple(row_ptr.shape)}")
        check_input(col.dim() == 1, "col must be 1-D")
        check_input(row_ptr.device == col.device, "row_ptr and col on different devices")
        check_input(col.shape[0] < 2**31, "edge offsets are int32: the graph must have < 2^31 edges")
        self.row_ptr = row_ptr.to(torch.int32)
        self.col = col.to(torch.int32)
        self.node_count = int(node_count)
        self.edge_count = int(col.shape[0] if edge_count is None else edge_count)
        self.max_degree = max_degree

    @property
    def device(self) -> torch.device:
        return self.col.device

    @staticmethod
    def from_coo(src: np.ndarray, dst: np.ndarray, node_count: int, *,
                 add_reverse: bool = False, device: DeviceLike = "cuda") -> "GraphStructure":
        """Host-side CSR build from a COO edge list, moved to ``device``."""
        dev = resolve_device(device)
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        if add_reverse:
            src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
        order = np.argsort(src, kind="stable")
        src, dst = src[order], dst[order]
        counts = np.bincount(src, minlength=node_count)
        row_ptr = np.concatenate([[0], np.cumsum(counts)])
        return GraphStructure(
            torch.from_numpy(row_ptr.astype(np.int32)).to(dev),
            torch.from_numpy(dst.astype(np.int32)).to(dev),
            node_count,
            edge_count=len(dst),
            max_degree=int(counts.max()) if node_count else 0,
        )

    def to_full_graph(self, *, windowed: bool = False, tile: int = 256):
        """The :class:`~wholegraph_tpu_torch.models.conv.FullGraph` of this
        CSR for exact full-graph passes (``structure.py:220-274``): messages
        flow col → row, ``edge_src = col``, ``edge_dst`` each edge's row,
        both on the graph's device, and the CSR itself as ``row_ptr``.

        ``windowed=True`` also runs ``plan_spmm_tiles`` (one host pass over
        the CSR) and records its ``window`` and ``edge_cap`` when the plan
        is feasible, None otherwise, as the JAX package does. Kernel G
        needs no plan, so the graph aggregates the same way either way."""
        from ..models.conv import FullGraph
        from ..ops.spmm import plan_spmm_tiles
        from ..ops.spmm_kernels import csr_edge_dst

        window = edge_cap = None
        if windowed:
            w, cap, feasible = plan_spmm_tiles(self.row_ptr.cpu().numpy(),
                                               self.col.cpu().numpy(), tile=tile)
            if feasible:
                window, edge_cap = int(w), int(cap)
        return FullGraph(
            edge_src=self.col,
            edge_dst=csr_edge_dst(self.row_ptr, self.col.shape[0]).to(torch.int32),
            num_nodes=self.node_count,
            row_ptr=self.row_ptr,
            window=window,
            edge_cap=edge_cap,
        )

    # -- sampling -------------------------------------------------------------

    def sample_one_hop(self, centers: torch.Tensor, max_sample: int, *, seed: int = 0,
                       hop: int = 0) -> SampleResult:
        """unweighted_sample_without_replacement_one_hop analog."""
        return csr_sample_neighbors(self.row_ptr, self.col, centers, max_sample,
                                    seed=seed, hop=hop)

    def multilayer_sample(self, centers: torch.Tensor, fanouts: Sequence[int], *,
                          seed: int = 0,
                          center_mask: Optional[torch.Tensor] = None) -> MultilayerSample:
        """multilayer_sample_without_replacement analog: per layer, sample
        and ``append_unique``, producing nested padded subgraphs."""
        n = self.node_count
        gids = centers.to(torch.int32)
        gmask = (torch.ones(gids.shape, dtype=torch.bool, device=gids.device)
                 if center_mask is None else center_mask)
        hops: List[HopSubgraph] = []
        level_gids, level_masks = [gids], [gmask]
        for l, K in enumerate(fanouts):
            U = gids.shape[0]
            res = self.sample_one_hop(torch.where(gmask, gids, 0), K, seed=seed, hop=l)
            emask = res.mask & gmask[:, None]
            # distinct dummy ids for padding targets keep their slots unique
            dummy = n + torch.arange(U, dtype=torch.int32, device=gids.device)
            tgt = torch.where(gmask, gids, dummy)
            nbrs = torch.where(emask, res.neighbors, 0).reshape(-1)
            uids, _, nmap = append_unique(tgt, nbrs, emask.reshape(-1))
            hops.append(HopSubgraph(
                nbr_idx=torch.where(emask, nmap.reshape(U, K), 0),
                mask=emask,
                center_mask=gmask,
            ))
            gmask = (uids >= 0) & (uids < n)
            # padding → the out-of-range sentinel n; gathers clip it and the
            # apply's mask= keeps it away from the table and optimizer state
            gids = torch.where(gmask, uids, n)
            level_gids.append(gids)
            level_masks.append(gmask)
        return MultilayerSample(hops=hops, unique_gids=gids, unique_mask=gmask,
                                level_gids=level_gids, level_masks=level_masks)
