"""The sparse optimizer (the ``sparse_apply`` span of
``Embedding.apply_gradients``) in the running training step: the median of
its device ms over a pass of replays inside a Timeline."""

from wgbench.metrics import _timeline as T


def read(ctx):
    r = T.reading(ctx, "train_epoch")
    return None if r is None else r["median_ms"].get("sparse_apply")
