"""Access methods: exact search and HNSW."""

from .flat import FlatIndex
from .hnsw import HNSWIndex

__all__ = ["FlatIndex", "HNSWIndex"]
