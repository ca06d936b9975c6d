"""Node-classification datasets and batch iteration, the offline half.

The port's own copy of the numpy-only part of
``wholegraph_tpu/graph/dataset.py`` (``:30-52, 92-162``):
:class:`NodeClassificationSplit`, :class:`NodeClassificationDataset`, the
community-structured :func:`synthetic_dataset` and :func:`batch_iterator`
(the reference's DistributedSampler loaders, torch/data_loader.py:20-103).
The same seed gives the same arrays and batches as the JAX package, bit for
bit. Loading the reference's converted binary layout
(``load_converted_dataset``, ``load_pickle_split``) comes with the IO slice.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class NodeClassificationSplit:
    idx: np.ndarray
    label: np.ndarray


@dataclasses.dataclass
class NodeClassificationDataset:
    """In-memory description of a node-classification task."""

    name: str
    node_count: int
    edge_count: int
    feat_dim: int
    num_classes: int
    row_ptr: np.ndarray
    col: np.ndarray
    features: Optional[np.ndarray]  # None when features load via filelist
    train: NodeClassificationSplit
    valid: NodeClassificationSplit
    test: NodeClassificationSplit
    feature_files: Optional[list] = None


def synthetic_dataset(n: int = 10_000, avg_deg: int = 15, feat_dim: int = 64,
                      num_classes: int = 8, seed: int = 0,
                      homophily: float = 0.8) -> NodeClassificationDataset:
    """Community-structured synthetic graph for offline runs: a share
    ``homophily`` of each node's edges go to nodes of its own class, and its
    features carry its class as a one-hot times 1.5 over unit noise, so
    labels are recoverable from neighbourhoods. Splits 60 / 20 / 20 %."""
    rs = np.random.RandomState(seed)
    labels = rs.randint(0, num_classes, n)
    deg = np.maximum(rs.poisson(avg_deg, n), 1)
    src = np.repeat(np.arange(n, dtype=np.int64), deg)
    same = rs.rand(len(src)) < homophily
    dst = np.empty(len(src), np.int64)
    # same-class targets: a random node of the source's class, per class pool
    pools = [np.where(labels == c)[0] for c in range(num_classes)]
    for c in range(num_classes):
        m = same & (labels[src] == c)
        dst[m] = pools[c][rs.randint(0, len(pools[c]), m.sum())]
    m = ~same
    dst[m] = rs.randint(0, n, m.sum())
    order = np.argsort(src, kind="stable")
    src, dst = src[order], dst[order]
    counts = np.bincount(src, minlength=n)
    row_ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    feats = (rs.randn(n, feat_dim).astype(np.float32)
             + np.eye(num_classes, feat_dim, dtype=np.float32)[labels] * 1.5)
    perm = rs.permutation(n)
    n_train, n_valid = int(n * 0.6), int(n * 0.2)

    def split(idx):
        idx = np.sort(idx)
        return NodeClassificationSplit(idx=idx, label=labels[idx])

    return NodeClassificationDataset(
        name="synthetic", node_count=n, edge_count=int(row_ptr[-1]), feat_dim=feat_dim,
        num_classes=num_classes, row_ptr=row_ptr, col=dst.astype(np.int32), features=feats,
        train=split(perm[:n_train]), valid=split(perm[n_train:n_train + n_valid]),
        test=split(perm[n_train + n_valid:]),
    )


def batch_iterator(split: NodeClassificationSplit, batch_size: int, *, shuffle: bool = True,
                   seed: int = 0, drop_last: bool = True, process_rank: int = 0,
                   process_count: int = 1) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Shuffled, process-sharded mini-batches (DistributedSampler analog,
    torch/data_loader.py:72-78): the order is shuffled by
    ``RandomState(seed)``, process ``process_rank`` takes every
    ``process_count``-th entry of it, and ``drop_last`` (the training
    loader's default) drops a short last batch."""
    idx = split.idx
    order = np.arange(len(idx))
    if shuffle:
        np.random.RandomState(seed).shuffle(order)
    order = order[process_rank::process_count]
    nb = len(order) // batch_size if drop_last else -(-len(order) // batch_size)
    for b in range(nb):
        sel = order[b * batch_size:(b + 1) * batch_size]
        yield idx[sel], split.label[sel]
