"""Error types for wholegraph_tpu_torch.

Analog of the reference's ``wholememory_error_code_t`` enum and throwing
check macros (reference: cpp/include/wholememory/wholememory.h:32-44,
cpp/src/error.hpp), kept as Python exceptions carrying the code.
"""

from __future__ import annotations

import enum


class ErrorCode(enum.IntEnum):
    """Mirrors the reference error-code set (wholememory.h:32-44)."""

    SUCCESS = 0
    UNKNOWN_ERROR = 1
    NOT_IMPLEMENTED = 2
    LOGIC_ERROR = 3
    INVALID_INPUT = 4
    INVALID_VALUE = 5
    OUT_OF_MEMORY = 6
    NOT_SUPPORTED = 7
    SYSTEM_ERROR = 8


class WholeGraphError(RuntimeError):
    """Base error; carries an :class:`ErrorCode` for C-API parity."""

    code: ErrorCode = ErrorCode.UNKNOWN_ERROR

    def __init__(self, msg: str = "", code: ErrorCode | None = None):
        super().__init__(msg)
        if code is not None:
            self.code = code


class LogicError(WholeGraphError):
    code = ErrorCode.LOGIC_ERROR


class InvalidInput(WholeGraphError):
    code = ErrorCode.INVALID_INPUT


class InvalidValue(WholeGraphError):
    code = ErrorCode.INVALID_VALUE


class NotSupported(WholeGraphError):
    code = ErrorCode.NOT_SUPPORTED


class CudaError(WholeGraphError):
    """A missing CUDA device, a failed kernel build or a failed launch."""

    code = ErrorCode.SYSTEM_ERROR


def check(cond: bool, msg: str = "", exc: type[WholeGraphError] = LogicError) -> None:
    """Throwing check, analog of WHOLEMEMORY_CHECK (cpp/src/error.hpp)."""
    if not cond:
        raise exc(msg)


def check_input(cond: bool, msg: str = "") -> None:
    if not cond:
        raise InvalidInput(msg)
