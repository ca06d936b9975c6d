from . import rng
# the store's gather and scatter stay at ops.gather.gather / ops.gather.scatter:
# the name ``gather`` here is the module's
from .gather import local_add, local_take, local_take_sorted, local_write
from .gather_kernels import (ROW_GATHER, ROW_GATHER_MASKED, ROW_SCATTER, SAMPLE_COLS,
                             SORTED_GATHER, gather_rows, gather_rows_masked, gather_rows_sorted,
                             sample_cols, scatter_rows, scatter_rows_masked)
from .graph_ops import append_unique
from .host_kernels import (HOST_GATHER, HOST_SCATTER, host_gather_rows, host_scatter_rows,
                           pinned_empty)
from .sampling import SampleResult, csr_sample_neighbors
from .spmm import padded_gather_neighbors, padded_reduce, padded_softmax
from .spmm_kernels import (CSR_SDDMM, CSR_SPMM, NEIGHBOR_AGG, CsrSddmm, CsrSpmm, NeighborReduce,
                           csr_sddmm, csr_spmm, neighbor_reduce, sddmm_window, spmm_window,
                           transpose_csr)

# every hand-written kernel of the port, one per C entry point
KERNELS = (ROW_GATHER, ROW_SCATTER, SAMPLE_COLS, NEIGHBOR_AGG, HOST_GATHER, HOST_SCATTER,
           CSR_SPMM, CSR_SDDMM, SORTED_GATHER, ROW_GATHER_MASKED)

__all__ = [
    "KERNELS",
    "rng",
    "local_add",
    "local_take",
    "local_take_sorted",
    "local_write",
    "gather_rows",
    "gather_rows_masked",
    "gather_rows_sorted",
    "sample_cols",
    "scatter_rows",
    "scatter_rows_masked",
    "append_unique",
    "host_gather_rows",
    "host_scatter_rows",
    "pinned_empty",
    "SampleResult",
    "csr_sample_neighbors",
    "padded_gather_neighbors",
    "padded_reduce",
    "padded_softmax",
    "NeighborReduce",
    "neighbor_reduce",
    "CsrSpmm",
    "CsrSddmm",
    "csr_spmm",
    "csr_sddmm",
    "transpose_csr",
    "spmm_window",
    "sddmm_window",
]
