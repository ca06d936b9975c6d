"""The whole inference batch's or pass's share of the chip's float32 peak:
its valid operations, as the cell's build counts them (its
``infer_flops``), over the window's seconds a batch or pass, in %; nothing
where the build does not count the cell's mode."""

from wgbench.metrics import counts as C


def read(ctx):
    flops = ctx.build.infer_flops(ctx)
    if flops is None:
        return None
    return 100.0 * flops / ctx.seconds_per_unit() / C.F32_FLOPS_PER_S
