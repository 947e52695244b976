"""State interchange with the reference package: its arrays
(:mod:`.convert`), its checkpoint directories (:mod:`.checkpoint`) and its
replication delta logs (:mod:`.replication`); COPY in and out
(:mod:`.copy`)."""

from .checkpoint import (FORMAT_VERSION, MAGIC, load_hnsw, load_ivfflat,
                         load_table, save_hnsw, save_ivfflat, save_table)
from .convert import (bit_table_from_numpy, hnsw_from_numpy,
                      ivfflat_from_numpy, sparse_table_from_numpy,
                      table_from_numpy)
from .replication import ReplicationLog, apply_deltas

__all__ = ["hnsw_from_numpy", "ivfflat_from_numpy", "table_from_numpy",
           "bit_table_from_numpy", "sparse_table_from_numpy",
           "save_table", "load_table", "save_hnsw", "load_hnsw",
           "save_ivfflat", "load_ivfflat", "MAGIC", "FORMAT_VERSION",
           "ReplicationLog", "apply_deltas"]
