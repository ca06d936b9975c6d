"""Device idle share over profiled inference batches or passes, in %."""

from wgbench.metrics._idle import idle_pct


def read(ctx):
    return idle_pct(ctx) if ctx.mode_name in ("sampled_infer", "full_graph_infer") else None
