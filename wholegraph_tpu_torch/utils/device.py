"""Device resolution for the port's entry points.

Entry points take ``device="cuda"`` by default and raise when CUDA is
missing: the port runs on the card, and only an explicit ``device="cpu"``
(as the tests pass) selects the kernels' plain PyTorch versions.
"""

from __future__ import annotations

from typing import Union

import torch

from .error import CudaError, check_input

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``torch.device`` for ``device``; raises :class:`CudaError` when a CUDA
    device is asked for and none is available."""
    dev = torch.device(device)
    check_input(dev.type in ("cuda", "cpu"), f"unsupported device {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise CudaError(
            f"device {dev} requested but CUDA is not available; "
            "pass device='cpu' explicitly to run the plain PyTorch versions"
        )
    return dev
