"""Build and load the port's hand-written Hopper kernels.

Every CUDA source under ``wholegraph_tpu_torch/csrc/`` is compiled by
``nvcc`` for ``sm_90a`` into its own shared library with a plain C
interface, under ``wholegraph_tpu_torch/_build/`` (listed in .gitignore),
and loaded with :mod:`ctypes`. Nothing is built or loaded when this module
is imported: the first launch of any kernel builds every source at once,
one ``nvcc`` process per source, all started together. A library's file
name carries a hash of its source, the headers (``*.cuh``) beside it and
the flags, so an edited source or header is rebuilt and a current one is
reused.

Each C entry point launches on the stream it is given, allocates nothing,
and returns ``cudaGetLastError()``; :class:`Kernel` raises when that is not
0 and otherwise adds one to its ``launches`` count, the count that shows a
run really went through the kernel.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, List, Optional, Sequence

from ..utils.error import CudaError

CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_libs: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> Optional[str]:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``; None when there is none."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    return None


def sources() -> List[str]:
    """Every CUDA source of the port, sorted."""
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def library_path(source: str) -> str:
    """Built library of ``source``: named by the source's stem and a hash of
    its text, the text of the headers (``*.cuh``) beside it, and the compiler
    flags."""
    h = hashlib.sha256()
    for path in [source, *sorted(glob.glob(os.path.join(os.path.dirname(source), "*.cuh")))]:
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()
    stem = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{digest[:16]}.so")


def build_all() -> Dict[str, float]:
    """Compile every source whose library is missing, all ``nvcc`` processes
    started together, each compiler's output (``-Xptxas -v``) kept in a
    ``.log`` beside its library. Returns the wall seconds of the build (0.0
    where the library was current). Raises :class:`CudaError` with the compiler's
    output on the first failure."""
    todo = [(s, library_path(s)) for s in sources() if not os.path.exists(library_path(s))]
    if not todo:
        return {os.path.basename(s): 0.0 for s in sources()}
    nvcc = find_nvcc()
    if nvcc is None:
        raise CudaError("nvcc not found (CUDA_HOME, PATH, /usr/local/cuda/bin); cannot build kernels")
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for src, lib in todo:
        tmp = f"{lib}.tmp{os.getpid()}"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, src]
        procs.append((src, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    secs, failed = {}, []
    for src, lib, tmp, p in procs:
        out, _ = p.communicate()
        secs[os.path.basename(src)] = time.perf_counter() - t0
        if p.returncode != 0:
            failed.append(f"{os.path.basename(src)} (rc {p.returncode}):\n{out}")
            continue
        with open(os.path.splitext(lib)[0] + ".log", "w") as f:
            f.write(out)
        os.replace(tmp, lib)
    if failed:
        raise CudaError("kernel build failed:\n" + "\n".join(failed))
    return secs


def load(source_name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source_name>``, building every source
    first if any library is missing."""
    if source_name not in _libs:
        build_all()
        path = library_path(os.path.join(CSRC, source_name))
        _libs[source_name] = ctypes.CDLL(path)
    return _libs[source_name]


class Kernel:
    """One hand-written CUDA kernel behind a C entry point.

    ``launches`` counts the calls of this wrapper that launched the kernel;
    callers reset it (``k.launches = 0``) and read it back to show a path
    went through the kernel. ``routes`` splits the count by the label a
    wrapper passes as ``route=`` (kernel G: ``"forward"`` and
    ``"transposed"``; kernel B: ``"masked"`` for the store's writes)."""

    def __init__(self, name: str, source: str, entry: str, argtypes: Sequence,
                 replaces: str):
        self.name = name
        self.source = source
        self.entry = entry
        self.argtypes = list(argtypes)
        self.replaces = replaces
        self.launches = 0
        self.routes: Dict[str, int] = {}
        self._fn = None

    def _load(self):
        lib = load(self.source)
        fn = getattr(lib, self.entry)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        err = lib.wg_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        self._fn, self._err = fn, err
        return fn

    def __call__(self, *args, route: Optional[str] = None) -> None:
        fn = self._fn or self._load()
        rc = fn(*args)
        if rc != 0:
            raise CudaError(
                f"{self.name}: launch failed with CUDA error {rc} "
                f"({self._err(rc).decode()})"
            )
        self.launches += 1
        if route is not None:
            self.routes[route] = self.routes.get(route, 0) + 1


def cuda_stream(device) -> int:
    """Raw handle of PyTorch's current stream on ``device``, for a C entry."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream


__all__ = ["Kernel", "build_all", "cuda_stream", "find_nvcc", "load", "sources",
           "library_path", "BUILD_DIR", "CSRC"]
