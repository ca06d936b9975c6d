"""The whole training step's share of the chip's float32 peak: the valid
operations of a step (the representative batch's, from the reference's
sampler) over the window's seconds a step, in %."""

from wgbench.inputs import layer_dims, layer_heads
from wgbench.metrics import counts as C


def read(ctx):
    if ctx.mode_name != "train_epoch":
        return None
    dims, c = layer_dims(ctx.cfg), ctx.counts()
    grad_in = bool(ctx.cfg["train_embedding"])
    if ctx.cfg["model"] == "sage":
        flops = C.sage_flops(c, dims, backward=True, input_grad=grad_in)
    else:
        flops = C.gat_flops(c, dims, layer_heads(ctx.cfg), backward=True, input_grad=grad_in)
    return 100.0 * flops / ctx.seconds_per_unit() / C.F32_FLOPS_PER_S
