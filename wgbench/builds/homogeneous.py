"""Build ``homogeneous``: one graph of one node type, its features as one
table, and ``models.HomoGNN`` (SAGE or GAT, as the configuration's
``model`` says) trained by ``train.train_epoch`` over a ``SageTrainState``.

Its inputs (:mod:`wgbench.inputs`) are the CSR (``row_ptr``, ``col``), the
``features``, ``labels`` and ``splits``, and the model's ``weights`` in the
plain reference's layout; its counts of operations are
:mod:`wgbench.metrics.counts`' SAGE and GAT counts.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import torch

from wgbench import inputs as I
from wgbench.metrics import counts as C

TINY = {
    "nodes": 3000, "undirected_edges": 24000, "feat_dim": 8, "num_classes": 5, "hidden": 16,
    "splits": {"train": 640, "valid": 160, "test": 2200},
    "graph": {"model": "chung_lu", "degree_exponent": 2.5, "max_expected_degree": 150},
}
TINY_FANOUTS = {"sage": [4, 3, 2], "gat": [3, 3]}


make_inputs = I.make_all  # the CSR, features, labels and splits, and the model's weights


class Built:
    """The port's graph, table, model, dense optimizer and training state."""

    def __init__(self, cfg: Dict, mix: Dict, inputs: Dict, device: torch.device):
        marks = [time.perf_counter()]
        from wholegraph_tpu_torch.embedding import Embedding, create_optimizer
        from wholegraph_tpu_torch.graph import GraphStructure
        from wholegraph_tpu_torch.models import HomoGNN
        from wholegraph_tpu_torch.train import SageTrainConfig, SageTrainState

        self.cfg, self.mix, self.device = cfg, mix, device
        n, dim = int(cfg["nodes"]), int(cfg["feat_dim"])
        row_ptr, col = inputs["row_ptr"], inputs["col"]
        self.max_degree = int((row_ptr[1:] - row_ptr[:-1]).max())
        marks.append(time.perf_counter())
        self.graph = GraphStructure(row_ptr, col, n, max_degree=self.max_degree)
        opt = create_optimizer(cfg["embedding_optimizer"])
        self.emb = Embedding(n, dim, opt, torch.float32, device, table=inputs["features"])
        marks.append(time.perf_counter())
        heads = int(cfg.get("heads", 1))
        self.model = HomoGNN(dim, int(cfg["hidden"]), int(cfg["num_classes"]),
                             num_layers=int(cfg["num_layers"]), dropout=float(cfg["dropout"]),
                             aggregator="mean", model_type=cfg["model"], num_heads=heads,
                             device=device)
        with torch.no_grad():
            for conv, wt in zip(self.model.convs, inputs["weights"]):
                conv.proj.weight.copy_(wt["w"].t())
                if cfg["model"] == "sage":
                    conv.proj.bias.copy_(wt["b"])
                else:
                    conv.attn_src.copy_(wt["attn_src"])
                    conv.attn_dst.copy_(wt["attn_dst"])
        marks.append(time.perf_counter())
        self.dense_opt = torch.optim.Adam(self.model.parameters(), lr=float(cfg["lr"]),
                                          capturable=device.type == "cuda")
        elr = cfg.get("embedding_lr")
        tcfg = SageTrainConfig(
            n_nodes=n, dim=dim, hidden=int(cfg["hidden"]), num_classes=int(cfg["num_classes"]),
            batch=int(mix["batch"]) if "batch" in mix else 1, fanouts=tuple(cfg["fanouts"]),
            lr=float(cfg["lr"]), model_type=cfg["model"], num_heads=heads,
            train_embedding=bool(cfg["train_embedding"]),
            embedding_lr=None if elr is None else float(elr),
            embedding_optimizer=cfg["embedding_optimizer"])
        self.state = SageTrainState(tcfg, self.graph, self.emb, self.model, self.dense_opt,
                                    inputs["labels"])
        marks.append(time.perf_counter())
        self.times = dict(zip(("imports", "graph and table", "model", "optimizer"),
                              (b - a for a, b in zip(marks, marks[1:]))))

    def leaves(self) -> Dict[str, torch.Tensor]:
        """The model's parameters under the reference's leaf names."""
        out = {}
        for i, conv in enumerate(self.model.convs):
            out[f"{i}.w"] = conv.proj.weight
            if self.cfg["model"] == "sage":
                out[f"{i}.b"] = conv.proj.bias
            else:
                out[f"{i}.attn_src"] = conv.attn_src
                out[f"{i}.attn_dst"] = conv.attn_dst
        return out


def train_flops(ctx) -> Optional[int]:
    """A training step's valid operations (the representative batch's, from
    the reference's sampler)."""
    if ctx.mode_name != "train_epoch":
        return None
    dims, c = I.layer_dims(ctx.cfg), ctx.counts()
    grad_in = bool(ctx.cfg["train_embedding"])
    if ctx.cfg["model"] == "sage":
        return C.sage_flops(c, dims, backward=True, input_grad=grad_in)
    return C.gat_flops(c, dims, I.layer_heads(ctx.cfg), backward=True, input_grad=grad_in)


def infer_flops(ctx) -> Optional[int]:
    """A sampled inference batch's or a full-graph pass's valid operations."""
    dims = I.layer_dims(ctx.cfg)
    if ctx.mode_name == "full_graph_infer" and ctx.cfg["model"] == "sage":
        return C.full_graph_sage_flops(int(ctx.cfg["nodes"]), int(ctx.mode.fg.edge_src.shape[0]),
                                       dims)
    if ctx.mode_name == "sampled_infer":
        c = ctx.counts()
        if ctx.cfg["model"] == "sage":
            return C.sage_flops(c, dims, backward=False, input_grad=False)
        return C.gat_flops(c, dims, I.layer_heads(ctx.cfg), backward=False, input_grad=False)
    return None


def tiny(cfg: Dict) -> Dict:
    """The configuration at a few thousand nodes, its fanouts cut by model."""
    d = dict(cfg, **TINY)
    d["fanouts"] = TINY_FANOUTS[d["model"]]
    return d
