"""DNA sequence helpers.

The reference implementation wraps sequences in a 4-bit-packed
``DnaSequence`` class (reference: src/dnasequence.cpp:8-210). On the host
side we instead keep sequences as uppercase ASCII ``bytes`` — numpy can
view them as ``uint8`` arrays for zero-copy vectorized k-mer encoding,
and Python slicing covers substr/append. Undefined (non-ACGT) content is
tracked by a cheap translate-based scan instead of a per-object flag.
"""

from __future__ import annotations

import numpy as np

# Base encoding used across the package (matches reference
# src/sequenceutils.cpp:7-19): A=0, C=1, G=2, T=3, anything else = 4.
_ENCODE_LUT = np.full(256, 4, dtype=np.uint8)
for i, bases in enumerate([b"Aa", b"Cc", b"Gg", b"Tt"]):
    for b in bases:
        _ENCODE_LUT[b] = i

_DECODE = np.frombuffer(b"ACGTN", dtype=np.uint8)

_COMPLEMENT = bytes.maketrans(b"ACGTacgt", b"TGCATGCA")

_VALID = frozenset(b"ACGT")


def normalize_sequence(seq: str | bytes) -> bytes:
    """Uppercase ASCII bytes for a sequence."""
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    return seq.upper()


def encode_bases(seq: bytes) -> np.ndarray:
    """Encode to uint8 codes: A=0 C=1 G=2 T=3, other=4."""
    arr = np.frombuffer(seq, dtype=np.uint8)
    return _ENCODE_LUT[arr]


def decode_bases(codes: np.ndarray) -> bytes:
    return _DECODE[np.minimum(codes, 4)].tobytes()


def contains_undefined(seq: bytes) -> bool:
    """True if the sequence has any non-ACGT character.

    Mirrors DnaSequence::contains_undefined (reference
    src/dnasequence.cpp:208-210): the reference marks a sequence
    undefined when any appended base encodes to 4.
    """
    # delete-based scan: C-speed for the overwhelmingly common
    # all-ACGT case (a Python genexpr per base dominated selection)
    return len(bytes(seq).translate(None, delete=b"ACGT")) > 0


def revcomp(seq: bytes) -> bytes:
    return seq.translate(_COMPLEMENT)[::-1]
