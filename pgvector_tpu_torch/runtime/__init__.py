"""Serving runtime — micro-batching executor for concurrent queries."""

from .executor import BatchingExecutor

__all__ = ["BatchingExecutor"]
