"""Plain GraphSAGE (mean) and GAT, on a sampled :class:`~.sampler.Sample`
or over a whole CSR, in float32.

Matrix products go through :func:`matmul`: float32 with TF32 off, or with
``precision="tf32"`` (the control) both operands rounded to TF32's 10-bit
mantissa, to nearest even, with f32 accumulation, in the forward and in
both products of the backward. The rounding is done here, so the control
reads the same on the CPU as on the card.

SAGE layer: ``[x_self, mean of the valid neighbours' x] @ w + b`` (a
target with no valid neighbour takes a zero mean); relu between layers.
GAT layer (heads ``H`` of width ``D``): ``f = x @ w``, the target's own row
joins its valid neighbours, ``alpha = softmax(leaky_relu(f_src . a_src +
f_dst . a_dst, 0.2))`` over them, out = ``sum alpha f_src``, heads
concatenated; relu between layers; the last layer has one head.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from .sampler import Sample, positions

NEG_SLOPE = 0.2


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (1 sign, 8 exponent, 10 mantissa bits), to
    nearest even, returned as float32."""
    b = x.contiguous().view(torch.int32)
    lsb = (b >> 13) & 1
    r = (b + 0x0FFF + lsb) & ~0x1FFF
    return r.view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return round_tf32(a) @ round_tf32(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = round_tf32(g)
        return g @ round_tf32(b).t(), round_tf32(a).t() @ g


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str = "float32") -> torch.Tensor:
    if precision == "tf32":
        return _TF32MatMul.apply(a, b)
    return a @ b


def sage_layer(x_src: torch.Tensor, self_idx: torch.Tensor, nbr_idx: torch.Tensor,
               valid: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               precision: str) -> torch.Tensor:
    m = valid.to(x_src.dtype)
    summed = (x_src[nbr_idx] * m[..., None]).sum(dim=1)
    mean = summed / m.sum(dim=1, keepdim=True).clamp(min=1.0)
    return matmul(torch.cat([x_src[self_idx], mean], dim=1), w, precision) + b


def gat_layer(x_src: torch.Tensor, self_idx: torch.Tensor, nbr_idx: torch.Tensor,
              valid: torch.Tensor, w: torch.Tensor, a_src: torch.Tensor,
              a_dst: torch.Tensor, precision: str) -> torch.Tensor:
    H, D = a_src.shape
    f = matmul(x_src, w, precision).view(-1, H, D)
    idx = torch.cat([self_idx[:, None], nbr_idx], dim=1)  # the target's own row first
    ok = torch.cat([torch.ones_like(valid[:, :1]), valid], dim=1)
    fn = f[idx]  # [T, K + 1, H, D]
    e_dst = (f[self_idx] * a_dst).sum(-1)  # [T, H]
    e_src = (fn * a_src).sum(-1)  # [T, K + 1, H]
    logits = F.leaky_relu(e_src + e_dst[:, None, :], NEG_SLOPE)
    logits = logits.masked_fill(~ok[..., None], float("-inf"))
    alpha = torch.softmax(logits, dim=1)
    return (alpha[..., None] * fn).sum(dim=1).reshape(idx.shape[0], H * D)


def sampled_forward(model: str, weights: List[Dict[str, torch.Tensor]], sample: Sample,
                    x_last: torch.Tensor, precision: str = "float32") -> torch.Tensor:
    """Logits of ``sample.levels[0]`` from ``x_last``, the rows of
    ``sample.levels[-1]``; layer ``i`` runs over hop ``L - 1 - i``."""
    L = len(weights)
    x = x_last
    for i, wt in enumerate(weights):
        h = L - 1 - i
        src, hop = sample.levels[h + 1], sample.hops[h]
        self_idx = positions(src, hop.targets)
        nbr_idx = torch.where(hop.valid, positions(src, hop.nbrs), 0)
        if model == "sage":
            x = sage_layer(x, self_idx, nbr_idx, hop.valid, wt["w"], wt["b"], precision)
        else:
            x = gat_layer(x, self_idx, nbr_idx, hop.valid, wt["w"], wt["attn_src"],
                          wt["attn_dst"], precision)
        if i < L - 1:
            x = F.relu(x)
    return x


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = logits - torch.logsumexp(logits, dim=1, keepdim=True)
    return -logp.gather(1, labels.long()[:, None]).mean()


@torch.no_grad()
def csr_mean(row_ptr: torch.Tensor, col: torch.Tensor, x: torch.Tensor,
             edge_block: int = 1 << 23) -> torch.Tensor:
    """``out[d] = mean of x[col[e]]`` over row ``d``'s edges (0 for an empty
    row), in blocks of ``edge_block`` edges so that it fits."""
    n = row_ptr.shape[0] - 1
    E = col.shape[0]
    out = torch.zeros((n, x.shape[1]), dtype=x.dtype, device=x.device)
    deg = (row_ptr[1:] - row_ptr[:-1]).to(torch.int64)
    rows = torch.repeat_interleave(torch.arange(n, device=x.device), deg)
    for e0 in range(0, E, edge_block):
        e1 = min(e0 + edge_block, E)
        out.index_add_(0, rows[e0:e1], x[col[e0:e1].to(torch.int64)])
    return out / deg.clamp(min=1).to(x.dtype)[:, None]


@torch.no_grad()
def full_graph_sage(row_ptr: torch.Tensor, col: torch.Tensor, x: torch.Tensor,
                    weights: List[Dict[str, torch.Tensor]], precision: str = "float32",
                    row_block: int = 1 << 20) -> torch.Tensor:
    """Every node's logits by the SAGE stack over the whole CSR (messages
    flow from ``col`` to the row), products in blocks of rows."""
    L = len(weights)
    for i, wt in enumerate(weights):
        mean = csr_mean(row_ptr, col, x)
        out = torch.empty((x.shape[0], wt["w"].shape[1]), dtype=x.dtype, device=x.device)
        for r0 in range(0, x.shape[0], row_block):
            r1 = min(r0 + row_block, x.shape[0])
            out[r0:r1] = matmul(torch.cat([x[r0:r1], mean[r0:r1]], dim=1), wt["w"],
                                precision) + wt["b"]
        del mean
        x = F.relu(out) if i < L - 1 else out
    return x
