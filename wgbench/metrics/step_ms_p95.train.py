"""The training step's tail: p95, by nearest rank, of the device ms from one
step's ``step`` span entry to the next one's (so the gaps between the
graph's replays count), over a pass of replays inside a Timeline."""

from wgbench.metrics import _timeline as T


def read(ctx):
    r = T.reading(ctx, "train_epoch")
    return None if r is None else r["step_ms_p95"]
