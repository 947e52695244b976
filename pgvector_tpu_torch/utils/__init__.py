"""Utilities: scan statistics, phase timers and build progress."""

from .stats import ScanStats
from .telemetry import HNSW_PHASES, Progress, Timers, timers

__all__ = ["ScanStats", "timers", "Timers", "Progress", "HNSW_PHASES"]
