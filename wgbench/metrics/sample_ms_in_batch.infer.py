"""The sampler (the ``sample`` span of ``GraphStructure.multilayer_sample``)
in the running evaluation body: the median of its device ms over the
mode's traced batches inside a Timeline."""

from wgbench.metrics import _timeline as T


def read(ctx):
    r = T.reading(ctx, "sampled_infer")
    return None if r is None else r["median_ms"].get("sample")
