"""Utilities: scan statistics, phase timers, build progress and
device-memory accounting."""

from .stats import ScanStats
from .telemetry import (HNSW_PHASES, Progress, Timers, hbm_bytes,
                        hnsw_hbm_bytes, ivfflat_hbm_bytes, table_hbm_bytes,
                        timers)

__all__ = ["ScanStats", "timers", "Timers", "Progress", "HNSW_PHASES",
           "hbm_bytes", "table_hbm_bytes", "hnsw_hbm_bytes",
           "ivfflat_hbm_bytes"]
