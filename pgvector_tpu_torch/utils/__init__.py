"""Utilities: scan statistics, phase timers and spans, host-read counters,
build progress and device-memory accounting."""

from .stats import ScanStats
from .telemetry import (HNSW_PHASES, Progress, Span, Timers, hbm_bytes,
                        hnsw_hbm_bytes, host_read, ivfflat_hbm_bytes,
                        table_hbm_bytes, timers)

__all__ = ["ScanStats", "timers", "Timers", "Span", "host_read", "Progress",
           "HNSW_PHASES", "hbm_bytes", "table_hbm_bytes", "hnsw_hbm_bytes",
           "ivfflat_hbm_bytes"]
