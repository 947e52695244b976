"""Multi-device scale-out — counterpart of ``pgvector_tpu.parallel``, the
library's replacement for the reference's multi-node story (SURVEY.md
§2.4.6: WAL streaming replicas + Citus/PgDog sharding, README.md:758-760).

Vectors and postings shard over a :class:`Mesh` of torch devices; queries
replicate; each shard computes a partial top-k on its device and the
results merge in shard order — "shard the table with Citus, run the same
index on every shard, merge the ORDER BY".  One process drives every
device in turn (no process group), as the reference's single-controller
``shard_map`` does; a mesh may name one device many times (four shards on
one card, eight on the CPU).

For read throughput, a 2-D ``(shard × qp)`` mesh (:func:`make_mesh2`)
adds query fan-out: the index replicates over ``qp`` and each replica
column answers its slice of the batch.
"""

from .mesh import Mesh, make_mesh, make_mesh2, shard_rows
from .sharded import (
    dim_sharded_exact_search,
    sharded_exact_search,
    sharded_kmeans_step,
    train_centers_sharded,
    DeviceShardedHNSWIndex,
    DeviceShardedIVFFlatIndex,
    ShardedFlatIndex,
    ShardedHNSWIndex,
    ShardedIVFFlatIndex,
)

__all__ = [
    "Mesh",
    "make_mesh",
    "make_mesh2",
    "shard_rows",
    "dim_sharded_exact_search",
    "sharded_exact_search",
    "sharded_kmeans_step",
    "train_centers_sharded",
    "DeviceShardedHNSWIndex",
    "DeviceShardedIVFFlatIndex",
    "ShardedFlatIndex",
    "ShardedHNSWIndex",
    "ShardedIVFFlatIndex",
]
