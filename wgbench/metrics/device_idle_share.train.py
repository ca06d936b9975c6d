"""Device idle share over a profiled training pass, in %."""

from wgbench.metrics._idle import idle_pct


def read(ctx):
    return idle_pct(ctx) if ctx.mode_name == "train_epoch" else None
