"""Full-graph aggregation (kernel G through ``models.conv._fg_spmm``, mean)
at a pass's calls: one a layer, over the whole CSR at the layer's input
width; their bound over their device time, in %."""

import torch

from wgbench.inputs import layer_dims
from wgbench.metrics import counts as C


def read(ctx):
    if ctx.mode_name != "full_graph_infer" or ctx.cfg["model"] != "sage":
        return None
    from wholegraph_tpu_torch.models.conv import _fg_spmm

    fg = ctx.mode.fg
    n, E = int(ctx.cfg["nodes"]), int(fg.edge_src.shape[0])
    dev = ctx.run.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    xs = [torch.randn((n, din), generator=gen, device=dev) for din, _ in layer_dims(ctx.cfg)]
    nbytes = sum(C.spmm_bytes(n, E, x.shape[1]) for x in xs)

    def step():
        with torch.no_grad():
            for x in xs:
                _fg_spmm(fg, x, "mean")

    return C.share_pct(C.bound_s(nbytes), ctx.device_s(step, n_iters=2))
