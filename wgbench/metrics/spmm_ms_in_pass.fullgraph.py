"""The full graph's aggregation (the ``fg_spmm`` spans of
``models.conv._fg_spmm``, kernel G) in the running pass: the device ms of a
pass's spans, summed, the median over the mode's traced passes inside a
Timeline."""

from wgbench.metrics import _timeline as T


def read(ctx):
    r = T.reading(ctx, "full_graph_infer")
    return None if r is None else r["fg_spmm_ms_a_pass"]
