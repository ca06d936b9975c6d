"""The yardstick's arithmetic: the chip's peaks, the bound rule, and the
bytes and operations of each layer's calls, from shapes and counts alone.

Peaks are those of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W limit): 3.35 TB/s of HBM3 and 67 TFLOP/s of float32 outside the
tensor cores (the port multiplies in float32 with TF32 off).

The bound rule: a call can take no less than its bytes over the bandwidth
and its operations over the peak, whichever is larger; each input byte
counts as read once and each output byte as written once, whatever the
kernel reads again, and only valid rows count (padding is neither read
nor owed). A roofline share is that bound over the measured time.

``SampleCounts`` are the valid sizes of one sampled batch: the unique
valid nodes of every level, the valid slots of every hop and the distinct
valid neighbours of every hop, from the reference's own sampler.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
ID_BYTES = 4  # int32 ids
MASK_BYTES = 1


def bound_s(nbytes: float, flops: float = 0.0) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)


def share_pct(bound: float, measured_s: Optional[float]) -> Optional[float]:
    """``bound / measured`` in %, None where nothing was measured."""
    if not measured_s or measured_s <= 0:
        return None
    return 100.0 * bound / measured_s


@dataclasses.dataclass
class SampleCounts:
    padded: List[int]  # padded slots of every level's id list: B, B(K0+1), ...
    levels: List[int]  # valid unique nodes of every level
    slots: List[int]  # valid sampled slots of every hop
    distinct: List[int]  # distinct valid neighbour ids of every hop
    fanouts: List[int]


def padded_levels(batch: int, fanouts: Sequence[int]) -> List[int]:
    out = [batch]
    for k in fanouts:
        out.append(out[-1] * (k + 1))
    return out


def gather_bytes(n_ids: int, n_valid_rows: int, row_bytes: int) -> int:
    """Kernel A at a call: the ids, each valid row read once and written once."""
    return n_ids * ID_BYTES + 2 * n_valid_rows * row_bytes


def agg_forward_bytes(targets: int, padded_targets: int, K: int, distinct: int,
                      row_bytes: int) -> int:
    """D's forward at a hop: the [B, K] ids and mask, each distinct valid
    neighbour row read once, each valid target's row written once."""
    return padded_targets * K * (ID_BYTES + MASK_BYTES) + (distinct + targets) * row_bytes


def agg_backward_bytes(targets: int, padded_targets: int, K: int, distinct: int,
                       row_bytes: int) -> int:
    """D's backward at a hop: the ids and mask, each valid target's
    cotangent read once, each distinct valid neighbour's gradient row
    written once."""
    return padded_targets * K * (ID_BYTES + MASK_BYTES) + (targets + distinct) * row_bytes


def agg_flops(slots: int, width: int) -> int:
    """Adds of a masked neighbour sum (the mean's division is per row)."""
    return slots * width


def lazy_adam_apply_bytes(n_slots: int, n_valid_rows: int, row_bytes: int) -> int:
    """L under LazyAdam at a call: ids and mask, and for every valid row the
    table, m, v and gradient rows read and the table, m and v rows written."""
    return n_slots * (ID_BYTES + MASK_BYTES) + 7 * n_valid_rows * row_bytes


def spmm_bytes(n_rows: int, n_edges: int, width: int, elem: int = 4) -> int:
    """G's forward: row_ptr and col read, each source row read once, each
    output row written once."""
    return (n_rows + 1) * ID_BYTES + n_edges * ID_BYTES + 2 * n_rows * width * elem


def gemm_flops(m: int, k: int, n: int) -> int:
    return 2 * m * k * n


def sage_flops(c: SampleCounts, dims: Sequence[tuple], backward: bool,
               input_grad: bool) -> int:
    """A sampled SAGE step's valid operations: each layer's product over its
    valid targets and its neighbour sum; with ``backward`` the product's
    weight gradient, and where the layer's input needs a gradient (every
    layer but the first, which needs one only where the table is trained)
    the product's input gradient and the sum's backward."""
    L = len(dims)
    total = 0
    for i, (din, dout) in enumerate(dims):
        h = L - 1 - i
        t, slots = c.levels[h], c.slots[h]
        fwd = gemm_flops(t, 2 * din, dout) + agg_flops(slots, din)
        total += fwd
        if backward:
            total += gemm_flops(t, 2 * din, dout)
            if i > 0 or input_grad:
                total += gemm_flops(t, 2 * din, dout) + agg_flops(slots, din)
    return total


def gat_flops(c: SampleCounts, dims: Sequence[tuple], heads: Sequence[int], backward: bool,
              input_grad: bool) -> int:
    """A sampled GAT step's valid operations: each layer's projection of its
    valid sources, the attention terms and the weighted sum over the valid
    slots and the self loop; the backward doubles each and adds the input
    gradient of the projection where the input needs one."""
    L = len(dims)
    total = 0
    for i, ((din, dout), H) in enumerate(zip(dims, heads)):
        h = L - 1 - i
        src, t, slots = c.levels[h + 1], c.levels[h], c.slots[h]
        width = dout  # H heads of dout // H
        proj = gemm_flops(src, din, width)
        attn = 2 * t * width + 2 * (slots + t) * width * 2
        total += proj + attn
        if backward:
            total += proj + 2 * attn
            if i > 0 or input_grad:
                total += proj
    return total


def full_graph_sage_flops(n: int, n_edges: int, dims: Sequence[tuple]) -> int:
    return sum(gemm_flops(n, 2 * din, dout) + agg_flops(n_edges, din) for din, dout in dims)
