"""Dtype registry and converters.

Analog of the reference's dtype enum (reference:
cpp/include/wholememory/tensor_description.h:29-99): the same logical dtype
names, mapped onto torch and numpy dtypes. Element sizes match the
reference's on-disk binary layout.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

# Logical dtype names mirroring wholememory_dtype_t (tensor_description.h:29-41)
DTYPES = {
    "float": torch.float32,
    "float32": torch.float32,
    "half": torch.float16,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "double": torch.float64,
    "float64": torch.float64,
    "int8": torch.int8,
    "int16": torch.int16,
    "int": torch.int32,
    "int32": torch.int32,
    "int64": torch.int64,
    "uint8": torch.uint8,
    "uint32": torch.uint32,
    "uint64": torch.uint64,
}

DtypeLike = Union[str, np.dtype, type, torch.dtype]


def as_torch_dtype(dt: DtypeLike) -> torch.dtype:
    """Parse a dtype name / numpy dtype / torch dtype into a torch dtype."""
    if isinstance(dt, torch.dtype):
        return dt
    if isinstance(dt, str):
        key = dt.lower()
        if key not in DTYPES:
            raise ValueError(f"unknown dtype name: {dt!r}")
        return DTYPES[key]
    name = np.dtype(dt).name
    if name not in DTYPES:
        raise ValueError(f"unsupported dtype: {dt!r}")
    return DTYPES[name]


def element_size(dt: DtypeLike) -> int:
    """Bytes per element — must match the reference's on-disk binary layout."""
    return as_torch_dtype(dt).itemsize


def is_floating(dt: DtypeLike) -> bool:
    return as_torch_dtype(dt).is_floating_point


def is_integer(dt: DtypeLike) -> bool:
    d = as_torch_dtype(dt)
    return not d.is_floating_point and not d.is_complex and d != torch.bool
