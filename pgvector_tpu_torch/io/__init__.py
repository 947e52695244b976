"""State interchange with the reference package."""

from .convert import hnsw_from_numpy, table_from_numpy

__all__ = ["hnsw_from_numpy", "table_from_numpy"]
