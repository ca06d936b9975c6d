"""``utils/perf.py``'s chained-call timer on the CPU, and the small public
names ported beside it: ``utils.dtypes.as_numpy_dtype`` against the JAX
package's and ``embedding.host_embedding.bench_host_gather``.
(``ops.gather.gather_hierarchical`` is held at world 4 in
``tests/test_torch_exchange.py``; the spans and the Timeline in
``tests/test_torch_timeline.py``.)

Exact: every numpy dtype. The timers are held to what a wall clock can
promise: positive seconds."""

import numpy as np
import pytest
import torch

from wholegraph_tpu.utils import dtypes as jdtypes
from wholegraph_tpu_torch.embedding.host_embedding import bench_host_gather
from wholegraph_tpu_torch.utils import dtypes, perf
from wholegraph_tpu_torch.utils.error import CudaError

torch.set_num_threads(1)


def test_measure_chain_on_the_cpu():
    x = torch.randn(64, 64)
    seen = []

    def step(i, a):
        seen.append(i)
        return a @ a

    dt = perf.measure_chain(step, 4, x, device="cpu")
    assert dt > 0 and seen == [0, 0, 0, 1, 2, 3, 4]  # warm, the one-call chain, the long one


def test_the_card_is_the_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(CudaError):
        perf.measure_chain(lambda i: None, 2)


@pytest.mark.parametrize("name", sorted(dtypes.DTYPES))
def test_as_numpy_dtype_is_jax(name):
    want = jdtypes.as_numpy_dtype(name)
    assert dtypes.as_numpy_dtype(name) == want
    assert dtypes.as_numpy_dtype(dtypes.as_torch_dtype(name)) == want
    if name != "bfloat16":  # numpy's own dtypes round-trip
        assert dtypes.as_numpy_dtype(np.dtype(want)) == want


@pytest.mark.parametrize("clustered", [False, True])
def test_bench_host_gather_on_the_cpu(clustered):
    gbps, dt = bench_host_gather(20_000, 16, 2048, iters=2, clustered=clustered, device="cpu")
    assert dt > 0 and gbps == pytest.approx(2048 * 16 * 4 / dt / 1e9)
