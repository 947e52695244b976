"""Device-resident tables."""

from .table import BaseTable, DenseTable

__all__ = ["BaseTable", "DenseTable"]
