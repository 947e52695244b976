"""``bit`` — fixed-length bit string with Hamming and Jaccard distances;
counterpart of :class:`pgvector_tpu.types.Bit` (reference: Postgres's
VarBit type with pgvector's distance functions, src/bitvec.c:45-70, over
the popcount kernels of src/bitutils.c:49-160).

The text form is a ``0``/``1`` string; the bytes are big-endian packed,
the first bit the MSB of byte 0 (the VARBITS layout, so binary_quantize
output is interchangeable).  Tables store bit strings as packed 32-bit
words (:func:`pgvector_tpu_torch.ops.distance.pack_bits`).
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np

from ..errors import DataException, InvalidTextRepresentation

#: the hnsw bit opclass limit (hnswutils.c:1394-1418)
BITVEC_MAX_DIM = 64000


class Bit:
    """A single bit-string value (a numpy bool array)."""

    __slots__ = ("bits",)

    type_name = "bit"

    def __init__(self, bits: Union[str, Sequence[bool], np.ndarray]):
        if isinstance(bits, str):
            if not set(bits) <= {"0", "1"}:
                bad = next(c for c in bits if c not in "01")
                raise InvalidTextRepresentation(
                    f'"{bad}" is not a valid binary digit')
            arr = np.frombuffer(bits.encode(), dtype=np.uint8) == ord("1")
        else:
            arr = np.asarray(bits, dtype=bool)
        if arr.ndim != 1:
            raise DataException("bit array must be 1-D")
        self.bits = arr

    @property
    def dim(self) -> int:
        return int(self.bits.shape[0])

    def __len__(self) -> int:
        return self.dim

    # -- text / bytes -----------------------------------------------------
    def to_text(self) -> str:
        return "".join("1" if b else "0" for b in self.bits)

    @classmethod
    def from_text(cls, lit: str) -> "Bit":
        return cls(lit)

    def to_bytes(self) -> bytes:
        """MSB-first packed bytes: bit i → byte i//8, bit 7-(i%8)
        (binary_quantize's packing, src/vector.c:952-978)."""
        return np.packbits(self.bits).tobytes()

    @classmethod
    def from_bytes(cls, data: bytes, dim: int) -> "Bit":
        arr = np.unpackbits(np.frombuffer(data, dtype=np.uint8))[:dim]
        return cls(arr.astype(bool))

    # -- distances --------------------------------------------------------
    def _check_dims(self, other: "Bit") -> None:
        # src/bitvec.c:33-39
        if self.dim != other.dim:
            raise DataException(
                f"different bit lengths {self.dim} and {other.dim}")

    def hamming_distance(self, other: "Bit") -> float:
        """popcount(a XOR b) (BitHammingDistance, src/bitutils.c:49-73)."""
        self._check_dims(other)
        return float(np.count_nonzero(self.bits != other.bits))

    def jaccard_distance(self, other: "Bit") -> float:
        """1 - |a∩b| / |a∪b|, and 1 when the intersection is empty
        (BitJaccardDistance, src/bitutils.c:98-131)."""
        self._check_dims(other)
        ab = int(np.count_nonzero(self.bits & other.bits))
        if ab == 0:
            return 1.0
        aa = int(np.count_nonzero(self.bits))
        bb = int(np.count_nonzero(other.bits))
        return 1.0 - ab / float(aa + bb - ab)

    # -- equality ----------------------------------------------------------
    def __eq__(self, o):
        return (isinstance(o, Bit) and self.dim == o.dim
                and bool((self.bits == o.bits).all()))

    def __ne__(self, o):
        return not self.__eq__(o)

    def __hash__(self) -> int:
        return hash((self.dim, self.to_bytes()))

    def __repr__(self) -> str:
        return f"Bit({self.to_text()!r})"

    def to_numpy(self) -> np.ndarray:
        return self.bits
