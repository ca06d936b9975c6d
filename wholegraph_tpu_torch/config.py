"""Argparse option groups of the examples.

The port's copy of ``wholegraph_tpu/config.py``, with the same groups,
options and defaults (the reference's composable option groups,
python torch/common_options.py:17-176), so a command line of the JAX
package's examples runs the port's. The port adds one option,
``--device`` (default ``cuda``, or ``WHOLEGRAPH_TORCH_DEVICE`` when the
launcher's ``--device cpu`` set it; ``cpu`` runs the kernels' plain
versions). The port's examples serve every option of the groups.
"""

from __future__ import annotations

import argparse
import os


def add_training_options(ap: argparse.ArgumentParser) -> None:
    g = ap.add_argument_group("training")
    g.add_argument("--epochs", type=int, default=4)
    g.add_argument("--batchsize", type=int, default=1024)
    g.add_argument("--lr", type=float, default=0.003)
    g.add_argument("--embedding-memory-type", default="distributed",
                   choices=["continuous", "chunked", "distributed", "hierarchy"],
                   help="reference memory types; each is one table on the card at world 1; "
                        "over several ranks the table is sharded over them ('hierarchy': "
                        "over a node x device mesh, rows gathered in two stages)")
    g.add_argument("--cache-type", default="none",
                   choices=["none", "local_device", "local_node", "all_devices"])
    g.add_argument("--cache-ratio", type=float, default=0.2)
    g.add_argument("--train-embedding", action="store_true",
                   help="train the feature table with a sparse optimizer")
    g.add_argument("--embed-optimizer", default="lazy_adam",
                   choices=["sgd", "lazy_adam", "rms_prop", "ada_grad"])
    g.add_argument("--capacity-factor", type=float, default=2.0,
                   help="per-round bucket headroom over the mean load of the exchange "
                        "between ranks: ids past it wait for a later round (no exchange, "
                        "so no effect, at world 1)")
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--device", default=os.environ.get("WHOLEGRAPH_TORCH_DEVICE", "cuda"),
                   help="cuda (the hand-written kernels) or cpu (their plain versions)")


def add_common_graph_options(ap: argparse.ArgumentParser) -> None:
    g = ap.add_argument_group("graph")
    g.add_argument("--root-dir", default=".",
                   help="dataset root (converted binary format)")
    g.add_argument("--graph-name", default="synthetic",
                   help="ogbn-arxiv | ogbn-products | ogbn-papers100M | synthetic")
    g.add_argument("--use-global-embedding", action="store_true")
    g.add_argument("--feat-dim", type=int, default=128)
    g.add_argument("--round-robin-size", type=int, default=0)


def add_common_model_options(ap: argparse.ArgumentParser) -> None:
    g = ap.add_argument_group("model")
    g.add_argument("--model", default="sage", choices=["sage", "gcn", "gat", "rgcn"])
    g.add_argument("--hiddensize", type=int, default=256)
    g.add_argument("--layernum", type=int, default=2)
    g.add_argument("--heads", type=int, default=4)
    g.add_argument("--dropout", type=float, default=0.5)
    g.add_argument("--classnum", type=int, default=40)
    g.add_argument("--aggregator", default="mean", choices=["mean", "sum", "max"])
    g.add_argument("--framework", default="wg",
                   help="dgl|pyg|wg|cugraph accepted for reference-CLI parity; "
                        "all resolve to the port's convs")


def add_common_sampler_options(ap: argparse.ArgumentParser) -> None:
    g = ap.add_argument_group("sampler")
    g.add_argument("--neighbors", default="30,30",
                   help="comma-separated fanout per layer")
    g.add_argument("--sample-method", default="unweighted",
                   choices=["unweighted", "weighted"])


def add_dataloader_options(ap: argparse.ArgumentParser) -> None:
    g = ap.add_argument_group("dataloader")
    g.add_argument("--dataloaderworkers", type=int, default=0)
    g.add_argument("--valid-batchsize", type=int, default=4096)


def parse_fanouts(s: str):
    return tuple(int(x) for x in s.split(",") if x)


def make_parser(description: str = "wholegraph_tpu_torch training") -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=description)
    add_training_options(ap)
    add_common_graph_options(ap)
    add_common_model_options(ap)
    add_common_sampler_options(ap)
    add_dataloader_options(ap)
    return ap
