"""Sampler (``GraphStructure.multilayer_sample``: kernel C a hop and
``append_unique``) at a training step's batch: device ms of one call."""


def read(ctx):
    if ctx.mode_name != "train_epoch":
        return None
    r = ctx.representative()
    s = ctx.device_s(lambda: ctx.built.graph.multilayer_sample(r["centers"], ctx.cfg["fanouts"],
                                                               seed=r["seed"]))
    return None if s is None else 1e3 * s
