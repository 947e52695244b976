"""GUC-equivalent runtime configuration registry.

pgvector registers GUC variables with ranges/enums at load time
(reference: src/hnsw.c:81-112 HnswInit, src/ivfflat.c:38-59 IvfflatInit) and
lets users set them per connection or per transaction (``SET LOCAL``).  The
equivalent here is a typed registry with the same names, defaults and
ranges, plus a context manager for scoped overrides (the ``SET LOCAL``
analogue).

Index-level options (``m``, ``ef_construction``, ``lists`` — the reloptions
validated at DDL time, src/hnsw.c:238-250, src/ivfflat.c:156-167) live on the
index objects themselves, not here, matching the reference's split between
GUCs and reloptions.
"""

from __future__ import annotations

import contextlib
import os
import threading
import warnings
from dataclasses import dataclass
from typing import Any, Dict, Iterator, Optional, Sequence

from .errors import InvalidParameterValue


@dataclass(frozen=True)
class _Knob:
    name: str
    default: Any
    kind: str  # "int" | "float" | "enum" | "bool"
    lo: Optional[float] = None
    hi: Optional[float] = None
    choices: Optional[Sequence[str]] = None
    doc: str = ""


class Config:
    """Thread-local-aware configuration registry."""

    def __init__(self) -> None:
        self._knobs: Dict[str, _Knob] = {}
        self._global: Dict[str, Any] = {}
        self._local = threading.local()

    # -- registration -----------------------------------------------------
    def register_int(self, name: str, default: int, lo: int, hi: int, doc: str = "") -> None:
        self._knobs[name] = _Knob(name, default, "int", lo, hi, None, doc)

    def register_float(self, name: str, default: float, lo: float, hi: float, doc: str = "") -> None:
        self._knobs[name] = _Knob(name, default, "float", lo, hi, None, doc)

    def register_enum(self, name: str, default: str, choices: Sequence[str], doc: str = "") -> None:
        self._knobs[name] = _Knob(name, default, "enum", None, None, tuple(choices), doc)

    def register_bool(self, name: str, default: bool, doc: str = "") -> None:
        self._knobs[name] = _Knob(name, default, "bool", None, None, None, doc)

    # -- access -----------------------------------------------------------
    def _check(self, knob: _Knob, value: Any) -> Any:
        if knob.kind == "int":
            value = int(value)
            if value < knob.lo or value > knob.hi:
                raise InvalidParameterValue(
                    f'{value} is outside the valid range for parameter "{knob.name}" '
                    f"({int(knob.lo)} .. {int(knob.hi)})"
                )
        elif knob.kind == "float":
            value = float(value)
            if value < knob.lo or value > knob.hi:
                raise InvalidParameterValue(
                    f'{value} is outside the valid range for parameter "{knob.name}" '
                    f"({knob.lo} .. {knob.hi})"
                )
        elif knob.kind == "enum":
            if value not in knob.choices:
                raise InvalidParameterValue(
                    f'invalid value for parameter "{knob.name}": "{value}"'
                )
        elif knob.kind == "bool":
            value = bool(value)
        return value

    def set(self, name: str, value: Any) -> None:
        knob = self._knobs.get(name)
        if knob is None:
            raise InvalidParameterValue(f'unrecognized configuration parameter "{name}"')
        self._global[name] = self._check(knob, value)

    def get(self, name: str) -> Any:
        knob = self._knobs.get(name)
        if knob is None:
            raise InvalidParameterValue(f'unrecognized configuration parameter "{name}"')
        stack = getattr(self._local, "stack", None)
        if stack:
            for frame in reversed(stack):
                if name in frame:
                    return frame[name]
        return self._global.get(name, knob.default)

    def validate(self, name: str, value: Any) -> Any:
        """Range/enum-check an explicit value against a knob's bounds
        without setting it — used when callers pass knob values as direct
        arguments (e.g. ``search(..., ef_search=...)``), which must honor
        the same GUC ranges as SET (src/hnsw.c:93-109)."""
        knob = self._knobs.get(name)
        if knob is None:
            raise InvalidParameterValue(f'unrecognized configuration parameter "{name}"')
        return self._check(knob, value)

    def reset(self, name: Optional[str] = None) -> None:
        if name is None:
            self._global.clear()
        else:
            self._global.pop(name, None)

    @contextlib.contextmanager
    def local(self, **overrides: Any) -> Iterator[None]:
        """Scoped override — the ``SET LOCAL`` analogue."""
        frame = {}
        for name, value in overrides.items():
            knob = self._knobs.get(name)
            if knob is None:
                raise InvalidParameterValue(f'unrecognized configuration parameter "{name}"')
            frame[name] = self._check(knob, value)
        if not hasattr(self._local, "stack"):
            self._local.stack = []
        self._local.stack.append(frame)
        try:
            yield
        finally:
            self._local.stack.pop()

    def describe(self) -> Dict[str, Any]:
        return {k.name: {"default": k.default, "doc": k.doc} for k in self._knobs.values()}


#: The process-wide registry, mirroring _PG_init (src/vector.c:57-65).
config = Config()

# HNSW GUCs — src/hnsw.c:93-109
config.register_int("hnsw.ef_search", 40, 1, 1000, "search candidate list size")
config.register_enum(
    "hnsw.iterative_scan", "off", ("off", "relaxed_order", "strict_order"),
    "keep scanning for more results after ef_search is exhausted",
)
config.register_int("hnsw.max_scan_tuples", 20000, 1, 2**31 - 1,
                    "iterative scan tuple budget")
config.register_float("hnsw.scan_mem_multiplier", 1.0, 1.0, 1000.0,
                      "iterative scan memory budget multiplier")

# IVFFlat GUCs — src/ivfflat.c:45-56
config.register_int("ivfflat.probes", 1, 1, 32768, "number of lists to probe")
config.register_enum("ivfflat.iterative_scan", "off", ("off", "relaxed_order"),
                     "probe more lists after the initial batch is exhausted")
config.register_int("ivfflat.max_probes", 32768, 1, 32768,
                    "iterative scan probe budget")

# Postgres-inherited resource knobs pgvector consumes
# (maintenance_work_mem cliff: src/hnswbuild.c:530-549; work_mem cap:
# src/hnswscan.c:149-156).  Expressed in bytes of device memory here.
config.register_int("maintenance_work_mem", 16 * 1024**3, 1024**2, 2**53,
                    "build memory budget in bytes (device memory)")
config.register_int("work_mem", 1024**3, 1024**2, 2**53,
                    "per-scan memory budget in bytes")
config.register_int("max_parallel_maintenance_workers", 8, 0, 1024,
                    "build wave parallelism hint (devices used for build)")

# Accelerator compute knobs (no reference analogue; the CPU equivalent is
# the OPTFLAGS/DISPATCH compile-time tier, SURVEY.md §5 config system).
# ops.distance.dot_precision maps this onto torch's f32 matmul precision.
config.register_enum("compute.matmul_precision", "highest",
                     ("default", "high", "highest"),
                     "f32 matmul precision for distance matmuls")


def _env_int(name: str, default: int) -> int:
    """Parse an integer env var once at import; malformed or empty values
    fall back to the default instead of raising deep inside a build."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        return int(raw)
    except ValueError:
        warnings.warn(f"ignoring malformed {name}={raw!r}; using {default}")
        return default


# Structural device-memory bound on the sparse merge-join pairwise transients used by
# HNSW connect_level for sparsevec tables (see HNSWIndex._sparse_pair_rows_cap).
# Sits beside maintenance_work_mem so operators find it in one place; the env
# var PGVECTOR_TPU_SPARSE_PAIR_BYTES is honored as a startup override and is
# snapshot exactly once here (the bound cannot drift mid-build).
config.register_int(
    "hnsw.sparse_pair_bytes",
    _env_int("PGVECTOR_TPU_SPARSE_PAIR_BYTES", 2 << 30),
    1 << 20, 2**53,
    "device-memory transient budget for sparse pairwise merge-join temps",
)
