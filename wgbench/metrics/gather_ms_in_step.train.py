"""The embedding's gather (the ``gather`` span of ``train.gather_features``)
in the running training step: the median of its device ms over a pass of
replays inside a Timeline."""

from wgbench.metrics import _timeline as T


def read(ctx):
    r = T.reading(ctx, "train_epoch")
    return None if r is None else r["median_ms"].get("gather")
