"""Accuracy pin of the port's own training loop on the CPU.

The JAX pin (``tests/test_example_accuracy.py:52-60``) trains the example at
its ``--smoke`` settings (``examples/node_classification.py:71-78``) and
evaluates with exact full-graph message passing: 91.5 % measured, floor
80 %, an untrained model 12.5 %. This runs the same task through the port:
``synthetic_dataset(n=2000, feat_dim=32, num_classes=8)`` (bit-equal to the
JAX one), a 2-layer SAGE of hidden width 32 with dropout 0.5, batches of 256
from ``batch_iterator`` (seed + epoch, ``drop_last``), fanouts (5, 5) with
the sampler keyed by the global step, dense Adam at the example's 0.003,
fixed features (no embedding training, the example's default), 10 epochs;
then ``full_graph.eval_full_graph`` over the test split. The floor is the
JAX pin's 80 %."""

import numpy as np
import torch

from wholegraph_tpu_torch.embedding import Embedding
from wholegraph_tpu_torch.full_graph import eval_full_graph
from wholegraph_tpu_torch.graph import GraphStructure, batch_iterator, synthetic_dataset
from wholegraph_tpu_torch.models import HomoGNN, cross_entropy_loss

torch.set_num_threads(1)


def test_smoke_training_accuracy_pinned():
    ds = synthetic_dataset(n=2000, feat_dim=32, num_classes=8)
    g = GraphStructure(torch.from_numpy(ds.row_ptr.astype(np.int32)), torch.from_numpy(ds.col),
                       ds.node_count, max_degree=int(np.diff(ds.row_ptr).max()))
    emb = Embedding.create(ds.node_count, ds.feat_dim, device="cpu").from_array(ds.features)
    gen = torch.Generator().manual_seed(0)
    model = HomoGNN(ds.feat_dim, 32, ds.num_classes, num_layers=2, dropout=0.5, device="cpu")
    model.reset_parameters(gen)
    opt = torch.optim.Adam(model.parameters(), lr=0.003)
    labels = torch.from_numpy(np.zeros(ds.node_count, np.int64))
    for split in (ds.train, ds.valid, ds.test):
        labels[split.idx] = torch.from_numpy(split.label.astype(np.int64))
    step = 0
    for epoch in range(10):
        for centers, y in batch_iterator(ds.train, 256, seed=epoch):
            ml = g.multilayer_sample(torch.from_numpy(centers.astype(np.int32)), (5, 5),
                                     seed=step)
            rows = emb.gather(ml.unique_gids) * ml.unique_mask[:, None]
            logits = model(rows, ml, train=True, generator=gen)
            loss = cross_entropy_loss(logits, torch.from_numpy(y.astype(np.int32)))
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            step += 1
    assert step == 40 and np.isfinite(loss.item())
    fg = g.to_full_graph()
    test = torch.from_numpy(ds.test.idx)
    test_loss, acc = eval_full_graph(model, emb, fg, test, labels[test])
    print(f"[TEST] loss {float(test_loss):.4f} accuracy {float(acc) * 100:.2f}%")
    assert float(acc) >= 0.80, f"test accuracy {float(acc):.4f} below the pinned floor 0.80"
