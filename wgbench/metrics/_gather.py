"""Kernel A's share of its bound at a call of the embedding's gather, the
ids the mode's call passes: a sampled batch's unique ids, or every node."""

import torch

from wgbench.metrics import counts as C


def gather_share(ctx):
    from wholegraph_tpu_torch.train import gather_features

    row_bytes = int(ctx.cfg["feat_dim"]) * 4
    if ctx.mode_name == "full_graph_infer":
        n = int(ctx.cfg["nodes"])
        ids = torch.arange(n, dtype=torch.int32, device=ctx.run.device)
        nbytes = C.gather_bytes(n, n, row_bytes)
    else:
        ids = ctx.program_sample().unique_gids
        nbytes = C.gather_bytes(int(ids.shape[0]), ctx.counts().levels[-1], row_bytes)
    s = ctx.device_s(lambda: gather_features(ctx.built.state, ids))
    return C.share_pct(C.bound_s(nbytes), s)
