"""State interchange with the reference package: its arrays
(:mod:`.convert`) and its checkpoint directories (:mod:`.checkpoint`)."""

from .checkpoint import (load_hnsw, load_ivfflat, load_table, save_hnsw,
                         save_ivfflat, save_table)
from .convert import (bit_table_from_numpy, hnsw_from_numpy,
                      ivfflat_from_numpy, sparse_table_from_numpy,
                      table_from_numpy)

__all__ = ["hnsw_from_numpy", "ivfflat_from_numpy", "table_from_numpy",
           "bit_table_from_numpy", "sparse_table_from_numpy",
           "save_table", "load_table", "save_hnsw", "load_hnsw",
           "save_ivfflat", "load_ivfflat"]
