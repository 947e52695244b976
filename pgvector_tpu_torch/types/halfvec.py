"""``halfvec`` — the dense float16 value type, as far as the port's tables
and exact search take it; counterpart of
:class:`pgvector_tpu.types.HalfVec` (reference src/halfvec.c) for
construction only: at most 16,000 dimensions (src/halfvec.h:60), and
values that overflow float16 are refused as infinite.
"""

from __future__ import annotations

import numpy as np

from .vector import DenseValue

HALFVEC_MAX_DIM = 16000  # src/halfvec.h:60


class HalfVec(DenseValue):
    """A single dense fp16 vector value."""

    __slots__ = ()

    type_name = "halfvec"
    max_dim = HALFVEC_MAX_DIM
    dtype = np.float16
