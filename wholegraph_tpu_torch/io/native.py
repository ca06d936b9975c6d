"""ctypes binding of the port's native file reader and writer
(``csrc/fastio.cpp``, host C++).

The port's counterpart of ``wholegraph_tpu/io/native.py:80-123``. The
library is built by :func:`~wholegraph_tpu_torch.kernels.load_host` with the
host compiler at its first use, into ``wholegraph_tpu_torch/_build/``; a
failed build raises with the compiler's output (there is no fallback to
numpy IO). The numpy reader and writer in :mod:`.file_io` are the plain
versions the tests hold these against.

Buffers are numpy arrays or CPU tensors (pinned or not), contiguous; the
native code reads or writes their bytes in place. The interpreter lock is
released for the call (ctypes does so), so a reader thread overlaps the
caller's other work.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Sequence

import numpy as np
import torch

from .. import kernels
from ..utils.error import check_input

SOURCE = "fastio.cpp"
DEFAULT_THREADS = min(os.cpu_count() or 4, 16)
# O_DIRECT (no page cache) for the loads that leave ``direct`` None, read from the environment
# at import (``wholegraph_tpu/io/native.py:77``): WGTPU_DIRECT_IO=1 turns it on
DIRECT_IO = os.environ.get("WGTPU_DIRECT_IO", "0") == "1"

_P = ctypes.c_void_p


def _lib() -> ctypes.CDLL:
    """The built library with its two entry points' types declared."""
    lib = kernels.load_host(SOURCE)
    lib.wgtpu_read_rows_v2.restype = ctypes.c_int
    lib.wgtpu_read_rows_v2.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, _P, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int)]
    lib.wgtpu_write_rows.restype = ctypes.c_int
    lib.wgtpu_write_rows.argtypes = [ctypes.c_char_p, _P, ctypes.c_int64, ctypes.c_int]
    return lib


def _buffer(buf):
    """(address, bytes) of a contiguous numpy array or CPU tensor."""
    if isinstance(buf, torch.Tensor):
        check_input(buf.device.type == "cpu" and buf.is_contiguous(),
                    "a native IO buffer must be a contiguous CPU tensor")
        return buf.data_ptr(), buf.numel() * buf.element_size()
    check_input(isinstance(buf, np.ndarray) and buf.flags["C_CONTIGUOUS"],
                "a native IO buffer must be a contiguous numpy array or CPU tensor")
    return buf.ctypes.data, buf.nbytes


def read_rows_native(filelist: Sequence[str], file_starts, entry_size: int, lo: int, hi: int,
                     out, nthreads: int = DEFAULT_THREADS,
                     direct: Optional[bool] = None) -> bool:
    """Read global rows ``[lo, hi)`` of the file list (rows of
    ``entry_size`` bytes, numbered in file order; ``file_starts`` the
    cumulative row counts, one more than the files) into the first
    ``(hi - lo) * entry_size`` bytes of ``out``. ``direct=True`` opens the
    files with O_DIRECT (no page cache, for cold bulk loads), falling back
    per file to buffered reads where the file system refuses it; None
    means :data:`DIRECT_IO`. Returns whether O_DIRECT opened every file
    the range touches (False without O_DIRECT)."""
    addr, nbytes = _buffer(out)
    check_input(0 <= lo <= hi, f"bad row range [{lo}, {hi})")
    check_input(nbytes >= (hi - lo) * entry_size, "output buffer too small")
    starts = np.ascontiguousarray(file_starts, dtype=np.int64)
    check_input(len(starts) == len(filelist) + 1 and hi <= starts[-1],
                f"row range [{lo}, {hi}) exceeds the file list's {starts[-1]} rows")
    paths = (ctypes.c_char_p * len(filelist))(*[os.fsencode(p) for p in filelist])
    direct = DIRECT_IO if direct is None else direct
    all_direct = ctypes.c_int(0)
    rc = _lib().wgtpu_read_rows_v2(paths, len(filelist),
                                   starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                                   entry_size, lo, hi, addr, nthreads, int(bool(direct)),
                                   ctypes.byref(all_direct))
    if rc != 0:
        raise OSError(rc, f"native read failed: {os.strerror(rc)}")
    return bool(all_direct.value)


def write_rows_native(path: str, data, nthreads: int = DEFAULT_THREADS) -> None:
    """Write the bytes of ``data`` (a contiguous numpy array or CPU tensor)
    to ``path``, created or truncated, with threaded pwrite."""
    addr, nbytes = _buffer(data)
    rc = _lib().wgtpu_write_rows(os.fsencode(path), addr, nbytes, nthreads)
    if rc != 0:
        raise OSError(rc, f"native write failed: {os.strerror(rc)}")
