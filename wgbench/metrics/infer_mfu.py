"""The whole inference batch's or pass's share of the chip's float32 peak:
its valid operations over the window's seconds a batch or pass, in %."""

from wgbench.inputs import layer_dims, layer_heads
from wgbench.metrics import counts as C


def read(ctx):
    dims = layer_dims(ctx.cfg)
    if ctx.mode_name == "full_graph_infer" and ctx.cfg["model"] == "sage":
        flops = C.full_graph_sage_flops(int(ctx.cfg["nodes"]), int(ctx.mode.fg.edge_src.shape[0]),
                                        dims)
    elif ctx.mode_name == "sampled_infer":
        c = ctx.counts()
        if ctx.cfg["model"] == "sage":
            flops = C.sage_flops(c, dims, backward=False, input_grad=False)
        else:
            flops = C.gat_flops(c, dims, layer_heads(ctx.cfg), backward=False, input_grad=False)
    else:
        return None
    return 100.0 * flops / ctx.seconds_per_unit() / C.F32_FLOPS_PER_S
