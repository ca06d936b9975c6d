"""Sampled SAGE aggregation (kernel D, ``ops.spmm.padded_reduce`` mean) at a
training step's calls: every hop's forward, and the backward of each hop
whose input needs a gradient (all but the first layer's, unless the table
is trained), on inputs of the step's shapes; their bound over their device
time, in %."""

import torch

from wgbench.inputs import layer_dims
from wgbench.metrics import counts as C


def read(ctx):
    if ctx.mode_name != "train_epoch" or ctx.cfg["model"] != "sage":
        return None
    from wholegraph_tpu_torch.ops.spmm import padded_reduce

    ml, c = ctx.program_sample(), ctx.counts()
    dims = layer_dims(ctx.cfg)
    L = len(dims)
    dev = ctx.run.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    calls, nbytes = [], 0
    for i, (din, _) in enumerate(dims):
        h = L - 1 - i
        hop = ml.hops[h]
        grad = i > 0 or bool(ctx.cfg["train_embedding"])
        x = torch.randn((int(ml.level_gids[h + 1].shape[0]), din), generator=gen, device=dev)
        x.requires_grad_(grad)
        B, K = hop.nbr_idx.shape
        ct = torch.randn((B, din), generator=gen, device=dev)
        calls.append((x, hop.nbr_idx, hop.mask, ct, grad))
        row = din * 4
        nbytes += C.agg_forward_bytes(c.levels[h], B, K, c.distinct[h], row)
        if grad:
            nbytes += C.agg_backward_bytes(c.levels[h], B, K, c.distinct[h], row)

    def step():
        for x, idx, mask, ct, grad in calls:
            y = padded_reduce(x, idx, mask, "mean")
            if grad:
                torch.autograd.grad(y, x, ct)

    return C.share_pct(C.bound_s(nbytes), ctx.device_s(step))
