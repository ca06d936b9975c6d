from .error import (
    CudaError,
    ErrorCode,
    InvalidInput,
    InvalidValue,
    LogicError,
    NotSupported,
    WholeGraphError,
    check,
    check_input,
)
from .logger import debug, error, info, logger, set_log_level, trace, warn
from .dtypes import as_numpy_dtype, as_torch_dtype, element_size, is_floating, is_integer
from .device import resolve_device

__all__ = [
    "CudaError",
    "ErrorCode",
    "InvalidInput",
    "InvalidValue",
    "LogicError",
    "NotSupported",
    "WholeGraphError",
    "check",
    "check_input",
    "debug",
    "error",
    "info",
    "logger",
    "set_log_level",
    "trace",
    "warn",
    "as_numpy_dtype",
    "as_torch_dtype",
    "element_size",
    "is_floating",
    "is_integer",
    "resolve_device",
]
