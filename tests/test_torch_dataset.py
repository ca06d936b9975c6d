"""Port parity: the offline dataset of wholegraph_tpu_torch
(``graph/dataset.py``, the port's own numpy copy) is bit-equal to the JAX
package's: every array of ``synthetic_dataset`` for the same arguments, and
every batch of ``batch_iterator`` under shuffling, process sharding and
``drop_last``."""

import dataclasses

import numpy as np
import pytest

from wholegraph_tpu.graph import dataset as jds
from wholegraph_tpu_torch.graph import dataset as tds


@pytest.mark.parametrize("kw", [dict(), dict(n=2000, feat_dim=32, num_classes=8),
                                dict(n=500, avg_deg=3, feat_dim=4, num_classes=11, seed=5,
                                     homophily=0.3)])
def test_synthetic_dataset_bit_exact(kw):
    a, b = tds.synthetic_dataset(**kw), jds.synthetic_dataset(**kw)
    for f in dataclasses.fields(jds.NodeClassificationDataset):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(y, jds.NodeClassificationSplit):
            for g in ("idx", "label"):
                np.testing.assert_array_equal(getattr(x, g), getattr(y, g), err_msg=f.name)
                assert getattr(x, g).dtype == getattr(y, g).dtype
        elif isinstance(y, np.ndarray):
            assert x.dtype == y.dtype, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name
    assert a.edge_count == a.row_ptr[-1] == len(a.col)
    n = a.node_count
    assert len(a.train.idx) + len(a.valid.idx) + len(a.test.idx) == n


@pytest.mark.parametrize("batch,shuffle,seed,drop_last,rank,count", [
    (256, True, 0, True, 0, 1), (256, True, 3, False, 0, 1), (100, False, 0, True, 1, 4),
    (64, True, 7, False, 3, 4), (5000, True, 0, True, 0, 1), (5000, True, 0, False, 0, 2)])
def test_batch_iterator_bit_exact(batch, shuffle, seed, drop_last, rank, count):
    ds = tds.synthetic_dataset(n=2000, feat_dim=8)
    kw = dict(shuffle=shuffle, seed=seed, drop_last=drop_last, process_rank=rank,
              process_count=count)
    a = list(tds.batch_iterator(ds.train, batch, **kw))
    b = list(jds.batch_iterator(jds.NodeClassificationSplit(ds.train.idx, ds.train.label),
                                batch, **kw))
    assert len(a) == len(b)
    for (ia, la), (ib, lb) in zip(a, b):
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_array_equal(la, lb)
    if drop_last:
        assert all(len(i) == batch for i, _ in a)
