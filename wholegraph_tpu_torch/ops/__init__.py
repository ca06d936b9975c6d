from . import rng
from .gather import local_add, local_take, local_write
from .gather_kernels import gather_rows, sample_cols, scatter_rows
from .graph_ops import append_unique
from .sampling import SampleResult, csr_sample_neighbors
from .spmm import padded_gather_neighbors, padded_reduce, padded_softmax
from .spmm_kernels import NeighborReduce, neighbor_reduce

__all__ = [
    "rng",
    "local_add",
    "local_take",
    "local_write",
    "gather_rows",
    "sample_cols",
    "scatter_rows",
    "append_unique",
    "SampleResult",
    "csr_sample_neighbors",
    "padded_gather_neighbors",
    "padded_reduce",
    "padded_softmax",
    "NeighborReduce",
    "neighbor_reduce",
]
