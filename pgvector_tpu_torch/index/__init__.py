"""Access methods: exact search, HNSW and IVFFlat."""

from .flat import FlatIndex
from .hnsw import HNSWIndex
from .ivfflat import IVFFlatIndex

__all__ = ["FlatIndex", "HNSWIndex", "IVFFlatIndex"]
