"""Error-code taxonomy (reference: ``spi/StandardErrorCode.java``).

Maps engine exceptions to the reference's (code, name, type) triples so the
protocol surface reports structured errors instead of bare strings.  Codes
mirror StandardErrorCode's numbering for the subset this engine raises:
USER_ERROR for things the query author controls, INSUFFICIENT_RESOURCES
for budget violations, INTERNAL_ERROR otherwise.

Torch port of ``presto_tpu/utils/errors.py``: the card's own allocation
failure (``torch.OutOfMemoryError``) is EXCEEDED_LOCAL_MEMORY_LIMIT, as
the pool's MemoryBudgetExceeded is (the JAX package recognises XLA's
out-of-memory messages, ``presto_tpu/exec/runner.py`` ``_is_xla_oom``).
"""

from __future__ import annotations

from typing import Tuple

import torch

USER_ERROR = "USER_ERROR"
INTERNAL_ERROR = "INTERNAL_ERROR"
INSUFFICIENT_RESOURCES = "INSUFFICIENT_RESOURCES"

# (code, name, type) — numbering follows StandardErrorCode.java
GENERIC_USER_ERROR = (0, "GENERIC_USER_ERROR", USER_ERROR)
SYNTAX_ERROR = (1, "SYNTAX_ERROR", USER_ERROR)
DIVISION_BY_ZERO = (8, "DIVISION_BY_ZERO", USER_ERROR)
NOT_SUPPORTED = (13, "NOT_SUPPORTED", USER_ERROR)
INVALID_FUNCTION_ARGUMENT = (7, "INVALID_FUNCTION_ARGUMENT", USER_ERROR)
FUNCTION_NOT_FOUND = (45, "FUNCTION_NOT_FOUND", USER_ERROR)
COLUMN_NOT_FOUND = (47, "COLUMN_NOT_FOUND", USER_ERROR)
TABLE_NOT_FOUND = (46, "TABLE_NOT_FOUND", USER_ERROR)
NUMERIC_VALUE_OUT_OF_RANGE = (35, "NUMERIC_VALUE_OUT_OF_RANGE", USER_ERROR)
GENERIC_INTERNAL_ERROR = (65536, "GENERIC_INTERNAL_ERROR", INTERNAL_ERROR)
EXCEEDED_LOCAL_MEMORY_LIMIT = (131079, "EXCEEDED_LOCAL_MEMORY_LIMIT",
                               INSUFFICIENT_RESOURCES)


def classify(exc: BaseException) -> Tuple[int, str, str]:
    """Exception → (errorCode, errorName, errorType)."""
    from .memory import MemoryBudgetExceeded

    if isinstance(exc, (MemoryBudgetExceeded, torch.OutOfMemoryError)):
        return EXCEEDED_LOCAL_MEMORY_LIMIT
    if isinstance(exc, NotImplementedError):
        return NOT_SUPPORTED
    msg = str(exc).lower()
    if isinstance(exc, SyntaxError) or "parse error" in msg \
            or "unexpected token" in msg or "expected" in msg and \
            isinstance(exc, (ValueError, KeyError)) and "syntax" in msg:
        return SYNTAX_ERROR
    if "cannot resolve column" in msg or "unknown column" in msg:
        return COLUMN_NOT_FOUND
    if "unknown table" in msg or "no such table" in msg \
            or "table not found" in msg:
        return TABLE_NOT_FOUND
    if "unknown function" in msg or "unknown scalar" in msg:
        return FUNCTION_NOT_FOUND
    if "division by zero" in msg:
        return DIVISION_BY_ZERO
    if isinstance(exc, (ValueError, KeyError, TypeError)):
        return GENERIC_USER_ERROR
    return GENERIC_INTERNAL_ERROR
