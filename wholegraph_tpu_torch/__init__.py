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
:class:`.memory.PartitionPlan`); the eighth adds weighted sampling
(``SageTrainConfig(sample_method="weighted")``, kernel K), the windowed
sampled aggregation, the padded/CSR graph ops, the apply's
``unique_chunk``, the synthetic dataset (:mod:`.graph.dataset`) and the
compile-check entry (:mod:`.entry`); the tenth adds the sampled GCN and GAT,
RGCN (``SageTrainConfig(model_type=...)``), and the typed-node store and
model (:mod:`.graph.hetero`, :class:`.models.HeteroGNN`,
:func:`.train.hetero_train_step`); the eleventh the hot cache of a table
(:mod:`.embedding.cache`), file IO and checkpoints (:mod:`.io`, with the
native reader of ``csrc/fastio.cpp``), the examples' options
(:mod:`.config`) and the examples themselves (:mod:`.examples`, each run as
``python -m wholegraph_tpu_torch.examples.<name>``); the twelfth the
store and the embedding sharded over ranks, one process a rank
(:mod:`.parallel` over ``torch.distributed``, the exact exchange of
:mod:`.ops.gather`, the launcher :mod:`.launch`, the sampled step at world
W and :func:`.entry.dryrun_multichip`); the thirteenth the full graph at
world W with every activation row-sharded, over the halo-partitioned layout
(:mod:`.graph.partitioned`) or per edge (:mod:`.models.sharded_eval`);
the fifteenth the scanned epoch (:func:`.train.train_epoch`: one CUDA
graph of the step, replayed once a batch, the sampler's seed and
LazyAdam's corrections read on the card) and :mod:`.utils.perf`; the
sixteenth the scanned epoch at world W and the last public names of the
JAX package.
"""

from . import (config, embedding, entry, full_graph, graph, io, kernels, memory, models, ops,
               parallel, utils)
from .full_graph import (FullGraphConfig, build_full_graph, clustered_csr, eval_full_graph,
                         full_graph_value_and_grad)
from .memory import PartitionPlan, ShardedTable
from .train import (HeteroTrainConfig, HeteroTrainState, SageTrainConfig, SageTrainState,
                    build_hetero, build_synthetic, hetero_train_step, train_epoch, train_step)
from .version import __version__

__all__ = [
    "config",
    "embedding",
    "entry",
    "full_graph",
    "graph",
    "io",
    "kernels",
    "memory",
    "models",
    "ops",
    "parallel",
    "utils",
    "SageTrainConfig",
    "SageTrainState",
    "build_synthetic",
    "train_step",
    "train_epoch",
    "HeteroTrainConfig",
    "HeteroTrainState",
    "build_hetero",
    "hetero_train_step",
    "FullGraphConfig",
    "build_full_graph",
    "clustered_csr",
    "eval_full_graph",
    "full_graph_value_and_grad",
    "PartitionPlan",
    "ShardedTable",
]
