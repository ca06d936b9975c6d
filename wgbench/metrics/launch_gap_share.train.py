"""The device's time between training steps: the gaps from one ``step``
span's exit to the next one's entry, summed, over the time from the pass's
first entry to its last exit, in %, over a pass of replays inside a
Timeline (the launch of each replay of the step's graph)."""

from wgbench.metrics import _timeline as T


def read(ctx):
    r = T.reading(ctx, "train_epoch")
    return None if r is None else r["launch_gap_share"]
