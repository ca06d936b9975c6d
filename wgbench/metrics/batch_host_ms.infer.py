"""The host's enqueue time of an evaluation batch: the median host ms from
a batch's first span entry to its last span exit, over the mode's traced
batches inside a Timeline. Where it nears the batch's time, the host paces
the batch."""

from wgbench.metrics import _timeline as T


def read(ctx):
    r = T.reading(ctx, "sampled_infer")
    return None if r is None else r["batch_host_ms"]
