"""Embedding gather (kernel A) at an inference call: a sampled batch's
unique ids, or every node of a full-graph pass; its bound over its device
time, in %."""

from wgbench.metrics._gather import gather_share


def read(ctx):
    return gather_share(ctx) if ctx.mode_name in ("sampled_infer", "full_graph_infer") else None
