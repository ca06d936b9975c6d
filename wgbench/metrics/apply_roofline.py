"""Sparse optimizer (``Embedding.apply_gradients``: kernel L under LazyAdam)
at a training step's apply call: the step's unique ids and mask, gradients
of its shape, the step's LazyAdam row; its bound over its device time, in %."""

import torch

from wgbench.metrics import counts as C


def read(ctx):
    if ctx.mode_name != "train_epoch" or not ctx.cfg["train_embedding"]:
        return None
    if ctx.cfg["embedding_optimizer"] != "lazy_adam":
        return None
    ml, c = ctx.program_sample(), ctx.counts()
    emb = ctx.built.emb
    dev = ctx.run.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    ids = ml.unique_gids
    grads = torch.randn((int(ids.shape[0]), emb.dim), generator=gen, device=dev) * 1e-3
    corr = emb.optimizer.step_table([emb.step + 1], dev)[0]
    lr = float(ctx.cfg["embedding_lr"])
    nbytes = C.lazy_adam_apply_bytes(int(ids.shape[0]), c.levels[-1], emb.dim * 4)
    s = ctx.device_s(lambda: emb.apply_gradients(ids, grads, lr, mask=ml.unique_mask,
                                                 assume_unique=True, corrections=corr))
    return C.share_pct(C.bound_s(nbytes), s)
