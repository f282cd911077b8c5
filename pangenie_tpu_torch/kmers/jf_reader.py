"""Jellyfish 2 ``.jf`` database reader (compatibility input path).

Replaces the reference JellyfishReader (src/jellyfishreader.cpp): loads
a pre-computed jellyfish database of read k-mer counts instead of
counting reads. The supported format set MATCHES the reference's:
src/jellyfishreader.cpp:31-40 accepts exactly
``binary_dumper::format`` (the ``"binary/sorted"`` header value — what
`jellyfish count -C` writes) and throws "Unsupported format" for
anything else; its `binary_query` is jellyfish's mmap random-access
view over that same sorted file. Here the sorted records load eagerly
into the :class:`ExactKmerCounter` table instead of being mmap-probed
per query — batched lookups over a host array are the faster access
pattern for this pipeline's bulk selection queries.

File layout (validated against the reference's committed fixtures):
ASCII-digit JSON-length prefix, a JSON header (``canonical``,
``key_len`` bits, ``counter_len`` bytes, ``format``), then sorted
records of ceil(key_len/8) little-endian key bytes followed by
``counter_len`` little-endian count bytes. Keys use jellyfish's 2-bit
base packing (first base in the high bits), identical to ours.
"""

from __future__ import annotations

import json

import numpy as np

from .counter import ExactKmerCounter


def _parse_header(data: bytes):
    start = data.index(b"{")
    depth = 0
    end = None
    for i in range(start, len(data)):
        c = data[i : i + 1]
        if c == b"{":
            depth += 1
        elif c == b"}":
            depth -= 1
            if depth == 0:
                end = i + 1
                break
    if end is None:
        raise RuntimeError("JellyfishReader: malformed .jf header.")
    return json.loads(data[start:end]), end


def read_jf(filename: str, kmer_size: int) -> ExactKmerCounter:
    """Load a jellyfish database; validates k and canonicality
    (reference src/jellyfishreader.cpp:16-25)."""
    with open(filename, "rb") as f:
        data = f.read()
    header, payload_start = _parse_header(data)

    if not header.get("canonical", False):
        raise RuntimeError(
            "JellyfishReader: jellyfish database must be built with "
            "canonical kmers (-C)."
        )
    key_len = int(header["key_len"])
    if key_len != 2 * kmer_size:
        raise RuntimeError(
            f"JellyfishReader: database kmer size {key_len // 2} does not "
            f"match requested kmer size {kmer_size}."
        )
    fmt = header.get("format")
    if fmt != "binary/sorted":
        # same format coverage as the reference, same error shape
        # (src/jellyfishreader.cpp:37-40)
        raise RuntimeError(
            f"JellyfishReader: Unsupported format '{fmt}"
        )

    counter_len = int(header["counter_len"])
    key_bytes = (key_len + 7) // 8
    rec = key_bytes + counter_len
    payload = data[payload_start:]
    n = len(payload) // rec
    if n * rec != len(payload):
        raise RuntimeError("JellyfishReader: truncated .jf payload.")

    raw = np.frombuffer(payload[: n * rec], dtype=np.uint8).reshape(n, rec)
    keys = np.zeros(n, dtype=np.uint64)
    for b in range(key_bytes):
        keys |= raw[:, b].astype(np.uint64) << np.uint64(8 * b)
    counts = np.zeros(n, dtype=np.int64)
    for b in range(counter_len):
        counts |= raw[:, key_bytes + b].astype(np.int64) << np.int64(8 * b)

    order = np.argsort(keys, kind="stable")  # sorted on disk, but be safe
    return ExactKmerCounter(kmer_size, keys[order], counts[order])
