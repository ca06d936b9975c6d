"""Embedding gather (kernel A) at a training step's unique ids: its bound
over its device time, in %."""

from wgbench.metrics._gather import gather_share


def read(ctx):
    return gather_share(ctx) if ctx.mode_name == "train_epoch" else None
