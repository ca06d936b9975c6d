"""Row gathers, row scatters and sampled-column fetch: kernels A, B, I, J and C's fetch,
and the sorted-gather helpers.

The counterpart of ``wholegraph_tpu/ops/gather_pallas.py``. Each public
function here is a wrapper: on a CUDA tensor it launches its hand-written
Hopper kernel (``csrc/row_gather.cu``: A and J, ``csrc/row_scatter.cu``: B,
``csrc/sample_cols.cu``: C, ``csrc/sorted_gather.cu``: I) or raises; on a
CPU tensor, and only there, it runs the plain PyTorch version that sits
beside it (``*_plain``), which is also what the kernel is checked against
on the card.

Tables are flat ``[N, D]``: the TPU's native ``[N, D//128, 128]`` layout,
128-lane blocking and the padding of ids to multiples of 1024 stay behind.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from .. import kernels
from ..utils.dtypes import as_torch_dtype
from ..utils.error import CudaError, check_input

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64

ROW_GATHER = kernels.Kernel(
    "row_gather", "row_gather.cu", "wg_row_gather",
    [_P, _P, _I, _P, _L, _L, _L, _I, _I, _P],
    replaces="wholegraph_tpu/ops/gather_pallas.py:35",  # _gather_kernel
)
ROW_SCATTER = kernels.Kernel(
    "row_scatter", "row_scatter.cu", "wg_row_scatter",
    [_P, _P, _I, _P, _L, _L, _L, _I, _I, _P],
    # _scatter_kernel, and _masked_scatter_kernel through route="masked"
    replaces="wholegraph_tpu/ops/gather_pallas.py:102,1066",
)
ROW_GATHER_MASKED = kernels.Kernel(
    "row_gather_masked", "row_gather.cu", "wg_row_gather_masked",
    [_P, _P, _I, _P, _L, _L, _L, _I, _I, _P],
    replaces="wholegraph_tpu/ops/gather_pallas.py:1028",  # _masked_gather_kernel
)
SORTED_GATHER = kernels.Kernel(
    "sorted_gather", "sorted_gather.cu", "wg_sorted_gather",
    [_P, _P, _I, _P, _L, _L, _L, _I, _I, _I, _I, _P, _P],
    replaces="wholegraph_tpu/ops/gather_pallas.py:560",  # _window_gather_kernel
)
SAMPLE_COLS = kernels.Kernel(
    "sample_cols", "sample_cols.cu", "wg_sample_cols",
    [_P, _L, _P, _P, _P, _P, _L, _L, _P],
    # _gather_slab_kernel and _select_lanes_kernel
    replaces="wholegraph_tpu/ops/gather_pallas.py:346,445",
)


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True when every tensor is on one CUDA device, False when all are on
    the CPU; raises on a mix or on another device type."""
    types = {t.device.type for t in tensors}
    if types == {"cpu"}:
        return False
    if types == {"cuda"} and len({t.device for t in tensors}) == 1:
        return True
    raise CudaError(f"tensors must all be on the CPU or all on one CUDA device, got "
                    f"{[str(t.device) for t in tensors]}")


def vector_bytes(row_bytes: int, *ptrs: int) -> int:
    """Widest load (16, 8, 4, 2 or 1 bytes) that divides the row and every
    base pointer, so each row starts on a vector boundary."""
    for v in (16, 8, 4, 2, 1):
        if row_bytes % v == 0 and all(p % v == 0 for p in ptrs):
            return v
    return 1


def _check_rows(table: torch.Tensor, ids: torch.Tensor) -> None:
    check_input(table.dim() == 2, f"table must be [N, D], got {tuple(table.shape)}")
    check_input(ids.dim() == 1, f"ids must be 1-D, got {tuple(ids.shape)}")
    check_input(ids.dtype in (torch.int32, torch.int64), f"ids must be int32/int64, got {ids.dtype}")


def _gather_out(table: torch.Tensor, ids: torch.Tensor):
    """Checked contiguous ids, the output to fill and the row's bytes."""
    check_input(table.is_contiguous(), "table must be contiguous")
    ids = ids.contiguous()
    out = torch.empty((ids.shape[0], table.shape[1]), dtype=table.dtype, device=table.device)
    return ids, out, table.shape[1] * table.element_size()


# ---------------------------------------------------------------------------
# Kernel A: row gather
# ---------------------------------------------------------------------------

# output bytes a CTA of kernel A aims at (csrc/row_gather.cu)
GATHER_TILE_BYTES = 8 * 1024
GATHER_MAX_TILE = 1024  # ids a CTA of kernel A: 4 a thread at most


def gather_tile(row_bytes: int) -> int:
    """Ids per CTA of kernel A for rows of ``row_bytes``: as many as fill
    GATHER_TILE_BYTES of output, from 1 to GATHER_MAX_TILE."""
    return max(1, min(GATHER_MAX_TILE, GATHER_TILE_BYTES // max(row_bytes, 1)))


def gather_rows_plain(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``out[i] = table[clip(ids[i], 0, N-1)]``."""
    return table[ids.long().clamp(0, table.shape[0] - 1)]


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows of ``table`` [N, D] at ``ids`` [B], out-of-range ids clipped
    (the contract of ``gather_pallas.gather_rows_pallas``)."""
    _check_rows(table, ids)
    check_input(table.shape[0] > 0 or ids.numel() == 0, "gather from an empty table")
    if not on_cuda(table, ids):
        return gather_rows_plain(table, ids)
    ids, out, row_bytes = _gather_out(table, ids)
    if out.numel() == 0:
        return out
    vec = vector_bytes(row_bytes, table.data_ptr(), out.data_ptr())
    tile = gather_tile(row_bytes)
    check_input(tile * (row_bytes // vec) < 2**31, "a tile of rows must hold fewer than 2^31 vectors")
    ROW_GATHER(table.data_ptr(), ids.data_ptr(), int(ids.dtype == torch.int64),
               out.data_ptr(), table.shape[0], ids.shape[0], row_bytes, vec, tile,
               kernels.cuda_stream(table.device))
    return out


# ---------------------------------------------------------------------------
# Kernel B: row scatter
# ---------------------------------------------------------------------------

# bytes of rows a CTA of kernel B aims at, were all its ids valid, and the
# most ids a CTA takes (csrc/row_scatter.cu). On an H100 (tools/kernel_variants.py)
# 256-512 ids ran best at the hetero store's 64-192-byte rows, most ids masked,
# and 16-32 at 1 KB rows; 64 KB gives 341-512 and 64, the last as fast as the
# earlier kernel at 1 KB rows.
SCATTER_TILE_BYTES = 64 * 1024
SCATTER_MAX_TILE = 512


def scatter_tile(row_bytes: int) -> int:
    """Ids per CTA of kernel B for rows of ``row_bytes``: as many as would
    fill SCATTER_TILE_BYTES were all of them valid, from 1 to
    SCATTER_MAX_TILE (2 a thread). A masked id costs a CTA only its read,
    so narrow rows take the most ids."""
    return max(1, min(SCATTER_MAX_TILE, SCATTER_TILE_BYTES // max(row_bytes, 1)))


def scatter_rows_plain(table: torch.Tensor, ids: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``table[ids[i]] = rows[i]`` in place for ids in ``[0, N)``."""
    ok = (ids >= 0) & (ids < table.shape[0])
    table[ids[ok].long()] = rows[ok].to(table.dtype)
    return table


def _scatter(table: torch.Tensor, ids: torch.Tensor, rows: torch.Tensor, route) -> torch.Tensor:
    _check_rows(table, ids)
    check_input(rows.shape == (ids.shape[0], table.shape[1]),
                f"rows {tuple(rows.shape)} != ({ids.shape[0]}, {table.shape[1]})")
    check_input(rows.dtype == table.dtype, f"rows dtype {rows.dtype} != table dtype {table.dtype}")
    if not on_cuda(table, ids, rows):
        return scatter_rows_plain(table, ids, rows)
    check_input(table.is_contiguous(), "table must be contiguous")
    ids, rows = ids.contiguous(), rows.contiguous()
    row_bytes = table.shape[1] * table.element_size()
    if ids.numel() == 0 or row_bytes == 0 or table.shape[0] == 0:
        return table
    vec = vector_bytes(row_bytes, table.data_ptr(), rows.data_ptr())
    tile = scatter_tile(row_bytes)
    check_input(tile * (row_bytes // vec) < 2**31, "a tile of rows must hold fewer than 2^31 vectors")
    ROW_SCATTER(table.data_ptr(), ids.data_ptr(), int(ids.dtype == torch.int64),
                rows.data_ptr(), table.shape[0], ids.shape[0], row_bytes, vec, tile,
                kernels.cuda_stream(table.device), route=route)
    return table


def scatter_rows(table: torch.Tensor, ids: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Write ``rows`` [B, D] into ``table`` [N, D] at ``ids`` in place;
    ids outside ``[0, N)`` are skipped (the contract of
    ``gather_pallas.scatter_rows_pallas``, minus the TPU's row-0 dump). Ids
    in range must be unique: rows aimed at one id are written in parallel
    and may interleave vector by vector. Returns ``table``."""
    return _scatter(table, ids, rows, None)


def scatter_rows_masked(table: torch.Tensor, slots: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """The store's masked write (``gather_pallas.scatter_rows_masked``):
    ``table[slots[i]] = rows[i]`` in place for slots in ``[0, N)``, every
    other slot skipped; slots in range must be unique, as for
    :func:`scatter_rows`. Kernel B, whose contract this is, counted under
    ``route="masked"``. Returns ``table``."""
    return _scatter(table, slots, rows, "masked")


# ---------------------------------------------------------------------------
# Kernel J: masked row gather
# ---------------------------------------------------------------------------

# output bytes a CTA of kernel J aims at: tiles of 8 ids of 1 KB rows (on an
# H100, tools/kernel_variants.py: 16 and 32 KB tiles 0.5 % slower, 4 KB 3.5 %)
MASKED_TILE_BYTES = 8 * 1024


def masked_tile(row_bytes: int) -> int:
    """Ids per CTA of kernel J for rows of ``row_bytes``: as many as fill
    MASKED_TILE_BYTES of output, from 1 to 256 (one id a thread at most)."""
    return max(1, min(256, MASKED_TILE_BYTES // max(row_bytes, 1)))


def gather_rows_masked_plain(table: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """``out[i] = table[slots[i]]`` for ``0 <= slots[i] < N``, else a zero row."""
    valid = (slots >= 0) & (slots < table.shape[0])
    out = table.new_zeros((slots.shape[0], table.shape[1]))
    out[valid] = table[slots[valid].long()]
    return out


def gather_rows_masked(table: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """Rows of ``table`` [N, D] at ``slots`` [B]; a slot outside ``[0, N)``
    gives a zero row and reads nothing (the contract of
    ``gather_pallas.gather_rows_masked``, whose skipped rows are garbage,
    made zero). Kernel J on CUDA: kernel I's direct reads over tiles of
    :func:`masked_tile` ids."""
    _check_rows(table, slots)
    if not on_cuda(table, slots):
        return gather_rows_masked_plain(table, slots)
    slots, out, row_bytes = _gather_out(table, slots)
    if out.numel() == 0 or table.shape[0] == 0:
        return out.zero_()
    vec = vector_bytes(row_bytes, table.data_ptr(), out.data_ptr())
    tile = masked_tile(row_bytes)
    check_input(tile * (row_bytes // vec) < 2**31, "a tile of rows must hold fewer than 2^31 vectors")
    ROW_GATHER_MASKED(table.data_ptr(), slots.data_ptr(), int(slots.dtype == torch.int64),
                      out.data_ptr(), table.shape[0], slots.shape[0], row_bytes, vec, tile,
                      kernels.cuda_stream(table.device))
    return out


# ---------------------------------------------------------------------------
# Kernel I: sorted-window gather
# ---------------------------------------------------------------------------

# dynamic shared memory one CTA of kernel I may take on an H100 (sorted_gather.cu)
SORTED_SMEM_BYTES = 227 * 1024 - 1024
# the window a default tile aims at: four CTAs of 1 KB rows fit one SM
SORTED_WINDOW_BYTES = 48 * 1024


def _window_rows(tile: int, density: float) -> int:
    """Rows a tile's window needs at sorted-id density ``density`` (distinct
    rows over span): the mean span ``tile / d`` with a quarter more, five
    standard deviations of it (negative-binomial) and 8 rows of slack."""
    d = min(max(density, 0.05), 1.0)
    return math.ceil(1.25 * tile / d + 5.0 * math.sqrt(tile * (1.0 - d)) / d) + 8


def sorted_plan(row_bytes: int, *, density: float = 1.0, tile=None, window=None):
    """``(tile, window)`` of kernel I for rows of ``row_bytes``: ids per CTA
    (by default the largest power of two from 32 to 256, one id per thread
    at most, whose window stays within SORTED_WINDOW_BYTES) and rows the
    CTA's shared-memory window holds (by default sized for ``density``), the
    window capped at what shared memory holds beside the tile's ids. The
    launch caps it again at the longest span the kernel's per-tile rule can
    accept, so shared memory no tile would use is not reserved."""
    check_input(row_bytes > 0, "rows must not be empty")
    if tile is None:
        tile = 32
        while tile < 256 and _window_rows(2 * tile, density) * row_bytes <= SORTED_WINDOW_BYTES:
            tile *= 2
    check_input(tile >= 1, f"tile must be positive, got {tile}")
    if window is None:
        window = _window_rows(tile, density)
    ids_bytes = -(-tile * 8 // 16) * 16
    check_input(ids_bytes <= SORTED_SMEM_BYTES, f"tile {tile} does not fit shared memory")
    return tile, max(0, min(int(window), (SORTED_SMEM_BYTES - ids_bytes) // row_bytes))


def gather_rows_sorted(table: torch.Tensor, slots: torch.Tensor, *, tile=None, window=None,
                       density: float = 1.0, zero_invalid: bool = False,
                       _stats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rows of ``table`` [N, D] at ``slots`` [B], exact for any slots
    (sorted or not, duplicated, out of range) and fastest for sorted, dense
    ones. Each CTA of ``tile`` ids decides for itself: it copies the span of
    its rows into a shared-memory window of ``window`` rows when the span
    fits and moves no more 32-byte sectors than reading the tile's rows
    directly would, and reads the rows directly otherwise
    (:func:`sorted_plan` sizes tile and window from ``density``; the choice
    is the kernel's alone). A slot outside ``[0, N)`` is clipped, as in
    ``gather_pallas.local_take_sorted``, or with ``zero_invalid`` gives a
    zero row and reads nothing. Kernel I on CUDA; its plain versions are
    :func:`gather_rows_plain` and :func:`gather_rows_masked_plain`.

    ``_stats``, internal, for reports: an int64 tensor of 3 on the card to
    which the kernel adds the tiles it windowed, the tiles it read directly
    and the bytes it asked of device memory (each windowed span, each direct
    tile's valid rows); the plain version leaves it as it is."""
    _check_rows(table, slots)
    check_input(zero_invalid or table.shape[0] > 0 or slots.numel() == 0,
                "gather from an empty table")
    if not on_cuda(table, slots):
        plain = gather_rows_masked_plain if zero_invalid else gather_rows_plain
        return plain(table, slots)
    slots, out, row_bytes = _gather_out(table, slots)
    if out.numel() == 0 or table.shape[0] == 0:
        return out.zero_()
    tile, window = sorted_plan(row_bytes, density=density, tile=tile, window=window)
    vec = vector_bytes(row_bytes, table.data_ptr(), out.data_ptr())
    check_input(tile * (row_bytes // vec) < 2**31, "a tile of rows must hold fewer than 2^31 vectors")
    check_input(_stats is None or (_stats.dtype == torch.int64 and _stats.numel() >= 3
                                   and _stats.device == slots.device and _stats.is_contiguous()),
                "_stats must be a contiguous int64 tensor of 3 on the slots' device")
    SORTED_GATHER(table.data_ptr(), slots.data_ptr(), int(slots.dtype == torch.int64),
                  out.data_ptr(), table.shape[0], slots.shape[0], row_bytes, vec, tile, window,
                  int(zero_invalid), None if _stats is None else _stats.data_ptr(),
                  kernels.cuda_stream(table.device))
    return out


# The sorted-gather helpers of gather_pallas.py (:682, :764, :974)
# ---------------------------------------------------------------------------

# window starts aligned down to 32 rows, as the TPU plan aligns them
# (gather_pallas.py:557); only window_coverage reproduces that plan
_WALIGN = 32


def _window_plan_checked(tile: int, window: int, group: int, wsub: Optional[int]) -> int:
    if wsub is None:
        wsub = window - (group - 1) * tile
    check_input(tile >= 1 and group >= 1, f"tile {tile} and group {group} must be positive")
    check_input(window % _WALIGN == 0 and wsub % _WALIGN == 0,
                f"window {window} and wsub {wsub} must be multiples of {_WALIGN}")
    check_input(tile <= wsub <= window, f"need tile {tile} <= wsub {wsub} <= window {window}")
    return wsub


def window_coverage(ids: torch.Tensor, n_rows: int, *, tile: int = 256, window: int = 1024,
                    group: int = 1, wsub: Optional[int] = None):
    """For sorted ``ids``, the share of ids that fall inside their sub-tile's
    window slice under the JAX package's TPU plan (``gather_pallas.py:764``:
    steps of ``tile * group`` ids, each with a window of ``window`` rows
    aligned down to 32 and clamped into the table, each sub-tile of
    ``tile`` ids selecting from ``wsub`` rows of it), and the ids' density
    (distinct rows over span). Index math, bit-equal to JAX; returns two
    0-dim float32 tensors. The port's :func:`gather_rows_window` returns
    every row whatever this says (ROADMAP quirk R9)."""
    wsub = _window_plan_checked(tile, window, group, wsub)
    check_input(ids.dim() == 1 and ids.numel() > 0, "ids must be a non-empty 1-D tensor")
    B = ids.shape[0]
    step = tile * group
    idp = ids.to(torch.int32)
    pad = -B % step
    if pad:
        idp = torch.cat([idp, idp[-1:].expand(pad)])
    nmax = (n_rows - window) // _WALIGN * _WALIGN
    w0s = (idp[::step] // _WALIGN * _WALIGN).clamp(0, nmax)
    firsts = idp[::tile].reshape(-1, group)
    starts = ((firsts - w0s[:, None]) // _WALIGN * _WALIGN).clamp(0, window - wsub)
    off = idp.reshape(-1, group, tile) - (w0s[:, None] + starts)[:, :, None]
    miss = ((off < 0) | (off >= wsub)).reshape(-1)
    covered = (~miss).sum(dtype=torch.int32) - pad
    span = (idp[-1] - idp[0] + 1).clamp(min=1)
    distinct = 1 + (idp[1:] != idp[:-1]).sum(dtype=torch.int32)
    return covered.float() / B, distinct.float() / span.float()


def gather_rows_window(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``out[i] = table[clip(ids[i])]`` for sorted ``ids``: the windowed
    gather by name (``gather_pallas.py:682``), kernel I on the card. The
    TPU's DMA plan (``tile``, ``window``, ``group``, ``wsub``) is not taken:
    kernel I plans its own tiles and chooses window or direct reads per
    tile. So every row comes back: the TPU route returns zero rows for ids
    outside their sub-tile's window (see :func:`window_coverage`), the
    port never does (ROADMAP quirk R9)."""
    return gather_rows_sorted(table, ids)


def choose_gather_kernel(density: float, dtype, dim: int) -> str:
    """``"window"`` when kernel I's per-tile rule (``csrc/sorted_gather.cu``,
    step 2) would window a tile of sorted ids at ``density`` (distinct rows
    over span), else ``"ring"`` (row by row, as kernel A reads). The rule
    windows a tile when its span fits the window and the span's 32-byte
    sectors do not exceed those of reading each row directly: at rows of
    ``b`` bytes in a table that starts on a sector, when ``density >= b /
    (32 * s)``, ``s`` the sectors a row touches on average over the offsets
    a row can start at within a sector. The answer never falls from window
    to ring as density rises. Host math, held to kernel I's own counts on
    the card (``chip_smoke.py``'s ``[store]``, ``tests/test_torch_cuda.py``);
    no TPU rate is carried over (the JAX heuristic is calibrated on v5e)."""
    row_bytes = int(dim) * as_torch_dtype(dtype).itemsize
    check_input(row_bytes > 0, "rows must not be empty")
    d = min(max(float(density), 0.0), 1.0)
    if d <= 0.0:
        return "ring"
    tile, window = sorted_plan(row_bytes, density=d)
    span_fits = math.ceil(tile / d) <= window
    starts = range(0, 32, math.gcd(row_bytes, 32))
    direct_sectors = sum((o + row_bytes - 1) // 32 + 1 for o in starts) / len(starts)
    window_sectors = row_bytes / (32.0 * d)
    return "window" if span_fits and window_sectors <= direct_sectors else "ring"


# ---------------------------------------------------------------------------
# Kernel C's fetch route: sampled-column fetch of a draw made elsewhere (the
# uniform hop, draw and fetch in one launch, is in ops/sampling.py)
# ---------------------------------------------------------------------------


def sample_cols_plain(col: torch.Tensor, start: torch.Tensor, pos: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
    """``mask ? col[clip(start[:, None] + pos)] : -1``, int32."""
    e = (start.long()[:, None] + pos.long()).clamp(0, col.shape[0] - 1)
    return torch.where(mask, col[e].to(torch.int32), -1).to(torch.int32)


def sample_cols(col: torch.Tensor, start: torch.Tensor, pos: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    """The sampled neighbours ``col[start[b] + pos[b, k]]`` of a position
    draw made elsewhere, ``-1`` where ``mask`` is False; any fanout K. C's
    fetch route: kernels C and K fetch their own columns, so only a whole
    ``col`` beside a sharded ``row_ptr`` is read through it
    (``ops.sampling.csr_sample_neighbors_sharded``).

    col: [E] int32; start: [B] int32 (row_ptr of each centre);
    pos, mask: [B, K] int32 / bool. Returns [B, K] int32."""
    check_input(col.dim() == 1 and col.dtype == torch.int32, "col must be 1-D int32")
    check_input(start.dim() == 1 and start.dtype == torch.int32, "start must be 1-D int32")
    check_input(pos.dim() == 2 and pos.dtype == torch.int32, "pos must be [B, K] int32")
    check_input(mask.shape == pos.shape and mask.dtype == torch.bool, "mask must be bool like pos")
    check_input(pos.shape[0] == start.shape[0], "pos rows != start length")
    B, K = pos.shape
    if col.shape[0] == 0 or B * K == 0:
        return torch.full((B, K), -1, dtype=torch.int32, device=pos.device)
    if not on_cuda(col, start, pos, mask):
        return sample_cols_plain(col, start, pos, mask)
    col, start, pos, mask = (t.contiguous() for t in (col, start, pos, mask))
    out = torch.empty((B, K), dtype=torch.int32, device=pos.device)
    SAMPLE_COLS(col.data_ptr(), col.shape[0], start.data_ptr(), pos.data_ptr(),
                mask.data_ptr(), out.data_ptr(), B, K, kernels.cuda_stream(pos.device))
    return out
