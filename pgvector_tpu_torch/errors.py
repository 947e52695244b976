"""Error types mirroring pgvector's ereport taxonomy.

pgvector raises Postgres errors with SQLSTATE classes (reference:
src/vector.c:70-123, src/sparsevec.c:44-148).  The port (as the JAX package) maps
each errcode to a Python exception class so callers can catch the same
categories, and error messages keep the reference wording so behavior tests
can pin them.
"""

from __future__ import annotations


class VectorError(Exception):
    """Base class for all pgvector_tpu errors."""

    sqlstate = "XX000"


class DataException(VectorError):
    """ERRCODE_DATA_EXCEPTION — bad value (NaN, dim mismatch, ...).

    Reference: src/vector.c:74-77 (different dimensions), :111-123 (NaN/Inf).
    """

    sqlstate = "22000"


class InvalidTextRepresentation(VectorError):
    """ERRCODE_INVALID_TEXT_REPRESENTATION — malformed literal.

    Reference: src/vector.c:190-276.
    """

    sqlstate = "22P02"


class ProgramLimitExceeded(VectorError):
    """ERRCODE_PROGRAM_LIMIT_EXCEEDED — too many dimensions.

    Reference: src/vector.c:103-105.
    """

    sqlstate = "54000"


class NumericValueOutOfRange(VectorError):
    """ERRCODE_NUMERIC_VALUE_OUT_OF_RANGE — overflow/underflow.

    Reference: src/vector.c:240-243 (parse), :835-846 (arithmetic).
    """

    sqlstate = "22003"


class InvalidParameterValue(VectorError):
    """ERRCODE_INVALID_PARAMETER_VALUE — bad config / option value."""

    sqlstate = "22023"


class FeatureNotSupported(VectorError):
    """ERRCODE_FEATURE_NOT_SUPPORTED — e.g. type modifier rules."""

    sqlstate = "0A000"


class InternalError(VectorError):
    """Self-check failures, e.g. "hnsw graph not repaired"
    (src/hnswvacuum.c:578)."""

    sqlstate = "XX000"
