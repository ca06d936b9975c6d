from . import rng, spmm
# the store's gather stays at ops.gather.gather: the name ``gather`` here is the module's
# (imported as ``from wholegraph_tpu_torch.ops import gather``), where JAX's ops.gather is
# the function
from .gather import (gather_hierarchical, gather_overflow, local_add, local_take,
                     local_take_sorted, local_write, scatter)
from .gather_kernels import (ROW_GATHER, ROW_GATHER_MASKED, ROW_SCATTER, SAMPLE_COLS,
                             SORTED_GATHER, choose_gather_kernel, gather_rows,
                             gather_rows_masked, gather_rows_sorted, gather_rows_window,
                             sample_cols, scatter_rows, scatter_rows_masked, window_coverage)
from .graph_ops import add_self_loop_padded, append_unique, csr_add_self_loop, padded_to_csr
from .host_kernels import (HOST_GATHER, HOST_SCATTER, host_gather_rows, host_scatter_rows,
                           pinned_empty)
from .optim_kernels import (SPARSE_APPLY, SPARSE_APPLY_HOST, apply_rows, apply_rows_host,
                            apply_rows_plain)
from .sampling import (SAMPLE_HOP, SAMPLE_HOP_WEIGHTED, SampleResult, csr_sample_neighbors,
                       interleave_col_weights, sample_hop_uniform, sample_hop_weighted)
from .spmm import (padded_gather_neighbors, padded_reduce, padded_reduce_windowed,
                   padded_softmax)
from .spmm_kernels import (CSR_SDDMM, CSR_SPMM, NEIGHBOR_AGG, CsrSddmm, CsrSpmm, NeighborReduce,
                           csr_sddmm, csr_spmm, neighbor_reduce, sddmm_window, spmm_window,
                           transpose_csr)
from ..utils.perf import STAMP

# every hand-written kernel of the port, one per C entry point (STAMP: the Timeline's clock)
KERNELS = (ROW_GATHER, ROW_SCATTER, SAMPLE_HOP, SAMPLE_COLS, NEIGHBOR_AGG, HOST_GATHER,
           HOST_SCATTER, CSR_SPMM, CSR_SDDMM, SORTED_GATHER, ROW_GATHER_MASKED, SAMPLE_HOP_WEIGHTED,
           SPARSE_APPLY, SPARSE_APPLY_HOST, STAMP)

__all__ = [
    "KERNELS",
    "rng",
    "spmm",
    "gather_hierarchical",
    "gather_overflow",
    "scatter",
    "choose_gather_kernel",
    "gather_rows_window",
    "window_coverage",
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
    "apply_rows",
    "apply_rows_plain",
    "apply_rows_host",
    "append_unique",
    "padded_to_csr",
    "csr_add_self_loop",
    "add_self_loop_padded",
    "host_gather_rows",
    "host_scatter_rows",
    "pinned_empty",
    "SampleResult",
    "csr_sample_neighbors",
    "sample_hop_uniform",
    "sample_hop_weighted",
    "interleave_col_weights",
    "padded_gather_neighbors",
    "padded_reduce",
    "padded_reduce_windowed",
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
