"""wholegraph_tpu_torch: the PyTorch and CUDA port of wholegraph_tpu.

The port runs on one NVIDIA Hopper card: plain tensor code is PyTorch, and
each TPU kernel of the ported path is a hand-written CUDA kernel for
``sm_90a`` (``csrc/``, built at first use by :mod:`.kernels`). Module names
mirror the JAX package's, so each counterpart is easy to find. Entry points
take ``device="cuda"`` by default and raise when CUDA is missing; an
explicit ``device="cpu"`` runs the kernels' plain PyTorch versions.

The first slice is the sampled GraphSAGE training step (:mod:`.train`); the
second puts its embedding in the host-memory tier
(:class:`.embedding.HostEmbedding`: the table and optimizer state in pinned
host memory behind a cache of hot rows on the card); the third is
full-graph message passing (:mod:`.full_graph`: SAGE, GCN and GAT over a
:class:`.models.FullGraph`, forward and backward); the fourth is the sharded
row store on one card (:class:`.memory.ShardedTable` with its
:class:`.memory.PartitionPlan`).
"""

from . import embedding, full_graph, graph, kernels, memory, models, ops, utils
from .full_graph import (FullGraphConfig, build_full_graph, clustered_csr, eval_full_graph,
                         full_graph_value_and_grad)
from .memory import PartitionPlan, ShardedTable
from .train import SageTrainConfig, SageTrainState, build_synthetic, train_step

__version__ = "0.1.0"

__all__ = [
    "embedding",
    "full_graph",
    "graph",
    "kernels",
    "memory",
    "models",
    "ops",
    "utils",
    "SageTrainConfig",
    "SageTrainState",
    "build_synthetic",
    "train_step",
    "FullGraphConfig",
    "build_full_graph",
    "clustered_csr",
    "eval_full_graph",
    "full_graph_value_and_grad",
    "PartitionPlan",
    "ShardedTable",
]
