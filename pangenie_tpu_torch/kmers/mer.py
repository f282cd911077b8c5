"""2-bit k-mer encoding and vectorized enumeration (host / numpy).

K-mers (k <= 31) are packed into uint64 with the FIRST base in the most
significant bits (A=0 < C=1 < G=2 < T=3), so integer order equals
lexicographic string order — this matches the jellyfish ``mer_dna``
ordering the reference relies on for its (ordered) kmer maps
(src/uniquekmercomputer.cpp:45-92 iterates a std::map<mer_dna, ...>).

Two enumeration flavours:

- :func:`enumerate_valid_kmers` — every window free of non-ACGT bases.
  This is what jellyfish's sequence parser produces when counting the
  graph corpus / reads.
- :func:`rolling_kmers_with_final` — the reference's ``unique_kmers()``
  helper (src/uniquekmercomputer.cpp:9-32): windows 0..L-k-1 only when
  free of invalid bases, plus the FINAL window emitted unconditionally
  (with invalid bases shifted in as code 3 and, for L < k, implicit
  leading 'A's) — a quirk we replicate for output parity.
"""

from __future__ import annotations

import numpy as np

from ..io.sequence import encode_bases

__all__ = [
    "encode_kmer",
    "encode_kmer_strings",
    "decode_kmer",
    "revcomp_kmer",
    "canonicalize",
    "pack_windows",
    "enumerate_valid_kmers",
    "rolling_kmers_with_final",
    "flat_segment_kmers",
]


def encode_kmer(kmer: str | bytes, k: int | None = None) -> int:
    """Pack a single k-mer string into uint64 (invalid bases -> 3)."""
    if isinstance(kmer, str):
        kmer = kmer.encode("ascii")
    codes = encode_bases(kmer)
    codes = np.where(codes > 3, 3, codes)
    value = 0
    for c in codes:
        value = (value << 2) | int(c)
    return value


def encode_kmer_fields(fields, k: int) -> np.ndarray:
    """Bulk-pack comma-joined k-mer FIELDS (the kmer TSV's column
    format) without splitting out the individual strings — one
    C-level join/strip instead of millions of per-kmer list entries
    (reference src/kmerparser.cpp:16-28 tokenizes per kmer)."""
    if not fields:
        return np.empty(0, dtype=np.uint64)
    joined = ",".join(fields).replace(",", "").encode("ascii")
    if len(joined) % k:
        raise RuntimeError("encode_kmer_fields: non-uniform k-mer length.")
    n = len(joined) // k
    codes = encode_bases(joined)
    c = np.where(codes > 3, 3, codes).reshape(n, k)
    out = np.zeros(n, np.uint64)
    for i in range(k):
        out = (out << np.uint64(2)) | c[:, i].astype(np.uint64)
    return out


def encode_kmer_strings(kmers, k: int) -> np.ndarray:
    """Bulk-pack equal-length k-mer strings into uint64 (invalid -> 3).

    One join + LUT + shift instead of a Python loop per k-mer — the
    genotype-time TSV fill parses millions of k-mer strings
    (reference src/kmerparser.cpp:16-28).
    """
    n = len(kmers)
    if n == 0:
        return np.empty(0, dtype=np.uint64)
    joined = "".join(kmers).encode("ascii")
    if len(joined) != n * k:
        raise RuntimeError("encode_kmer_strings: non-uniform k-mer length.")
    codes = encode_bases(joined)
    c = np.where(codes > 3, 3, codes).reshape(n, k)
    # Horner over the k base columns in uint64 — ~11x faster than the
    # broadcasted [n, k] uint64 shift + or-reduce (no 8-byte blowup of
    # the full code matrix, one [n] accumulator pass per base)
    out = np.zeros(n, np.uint64)
    for i in range(k):
        out = (out << np.uint64(2)) | c[:, i].astype(np.uint64)
    return out


_DECODE_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def decode_kmers_bulk(values: np.ndarray, k: int) -> np.ndarray:
    """Decode packed k-mers to an [n] array of length-k byte strings.

    One shift/LUT pass instead of a Python loop per k-mer — the
    index-time TSV emits every selected kmer as text."""
    vals = np.asarray(values, dtype=np.uint64)
    shifts = (2 * (k - 1 - np.arange(k))).astype(np.uint64)
    codes = ((vals[:, None] >> shifts[None, :]) & np.uint64(3)).astype(
        np.uint8
    )
    chars = _DECODE_BASES[codes]  # [n, k] ASCII
    return np.ascontiguousarray(chars).view(f"S{k}")[:, 0]


def decode_kmer(value: int, k: int) -> str:
    bases = "ACGT"
    chars = []
    for i in range(k):
        chars.append(bases[(value >> (2 * (k - 1 - i))) & 3])
    return "".join(chars)


def revcomp_kmer(values: np.ndarray, k: int) -> np.ndarray:
    """Reverse complement of packed k-mers (vectorized bit-twiddling)."""
    v = values.astype(np.uint64)
    # complement: 3 - code == bitwise NOT of each 2-bit field
    v = ~v
    # reverse 2-bit fields within the 64-bit word
    v = ((v >> np.uint64(2)) & np.uint64(0x3333333333333333)) | (
        (v & np.uint64(0x3333333333333333)) << np.uint64(2)
    )
    v = ((v >> np.uint64(4)) & np.uint64(0x0F0F0F0F0F0F0F0F)) | (
        (v & np.uint64(0x0F0F0F0F0F0F0F0F)) << np.uint64(4)
    )
    v = ((v >> np.uint64(8)) & np.uint64(0x00FF00FF00FF00FF)) | (
        (v & np.uint64(0x00FF00FF00FF00FF)) << np.uint64(8)
    )
    v = ((v >> np.uint64(16)) & np.uint64(0x0000FFFF0000FFFF)) | (
        (v & np.uint64(0x0000FFFF0000FFFF)) << np.uint64(16)
    )
    v = (v >> np.uint64(32)) | (v << np.uint64(32))
    # the k-mer occupies the low 2k bits after full reversal of 32 fields
    v = v >> np.uint64(64 - 2 * k)
    return v


def canonicalize(values: np.ndarray, k: int) -> np.ndarray:
    """Canonical form = min(kmer, revcomp(kmer)), as jellyfish does."""
    rc = revcomp_kmer(values, k)
    return np.minimum(values.astype(np.uint64), rc)


def pack_windows(codes: np.ndarray, k: int) -> np.ndarray:
    """Pack every length-k window of a 2-bit code array into uint64.

    Doubling construction: O(L log k), no O(L*k) blowup. ``codes`` must
    already be in 0..3 (mask invalid beforehand).
    """
    L = len(codes)
    if L < k:
        return np.empty(0, dtype=np.uint64)
    # power-of-two window packings: pows[j][i] = packed window [i, i+2^j)
    pows = [codes.astype(np.uint64)]
    plen = 1
    while plen * 2 <= k:
        prev = pows[-1]
        n = len(prev) - plen
        pows.append((prev[:n] << np.uint64(2 * plen)) | prev[plen : plen + n])
        plen *= 2
    # stitch by the binary decomposition of k, most significant bit first
    result = None
    res_len = 0
    for j in range(len(pows) - 1, -1, -1):
        plen = 1 << j
        if k & plen:
            if result is None:
                result = pows[j]
                res_len = plen
            else:
                n_windows = L - (res_len + plen) + 1
                result = (result[:n_windows] << np.uint64(2 * plen)) | pows[j][
                    res_len : res_len + n_windows
                ]
                res_len += plen
    assert res_len == k
    return result[: L - k + 1]


def enumerate_valid_kmers(seq: bytes, k: int) -> np.ndarray:
    """All (non-canonical) k-mers over windows containing only ACGT."""
    codes = encode_bases(seq)
    L = len(codes)
    if L < k:
        return np.empty(0, dtype=np.uint64)
    invalid = (codes > 3).astype(np.int64)
    vals = pack_windows(np.where(codes > 3, 3, codes), k)
    # window s valid iff no invalid base in [s, s+k)
    csum = np.concatenate([[0], np.cumsum(invalid)])
    window_invalid = csum[k:] - csum[:-k]
    return vals[window_invalid == 0]


def rolling_kmers_with_final(seq: bytes, k: int) -> np.ndarray:
    """Reference ``unique_kmers()`` enumeration incl. the final-window quirk.

    Returns the multiset of emitted kmers (non-canonical). Windows
    0..L-k-1 are emitted when N-free; the final rolling window is
    emitted unconditionally (invalid bases -> code 3; if L < k the
    window begins with implicit zeros / 'A's).
    """
    codes = encode_bases(seq)
    L = len(codes)
    mask = np.uint64((1 << (2 * k)) - 1) if k < 32 else np.uint64(0xFFFFFFFFFFFFFFFF)
    if L == 0:
        return np.zeros(1, dtype=np.uint64)
    shifted = np.where(codes > 3, 3, codes).astype(np.uint64)
    if L < k:
        final = np.uint64(0)
        for c in shifted:
            final = ((final << np.uint64(2)) | c) & mask
        return np.array([final], dtype=np.uint64)
    vals = pack_windows(shifted, k)
    invalid = (codes > 3).astype(np.int64)
    csum = np.concatenate([[0], np.cumsum(invalid)])
    window_invalid = csum[k:] - csum[:-k]
    body = vals[:-1][window_invalid[:-1] == 0] if L - k + 1 > 1 else vals[:0]
    final = vals[-1]
    return np.concatenate([body, np.array([final], dtype=np.uint64)])


def unique_kmers_of_allele(seq: bytes, k: int) -> np.ndarray:
    """K-mers occurring exactly once within the allele sequence.

    (reference src/uniquekmercomputer.cpp:28-31: keep count==1 entries)
    """
    emitted = rolling_kmers_with_final(seq, k)
    uniq, counts = np.unique(emitted, return_counts=True)
    return uniq[counts == 1]


def flat_segment_kmers(seqs, k: int):
    """:func:`rolling_kmers_with_final` over MANY sequences at once.

    One encode + one :func:`pack_windows` over the concatenation of all
    segments, instead of a numpy pipeline per allele — the per-bubble
    enumeration was the genome-scale wall of unique-kmer selection.

    Returns ``(kmers uint64, seg_ids int32)``: the emitted multiset of
    every segment (body windows when N-free plus the final window
    unconditionally), segment ids non-decreasing, kmers in window order
    within each segment.
    """
    n = len(seqs)
    if n == 0:
        return np.empty(0, np.uint64), np.empty(0, np.int32)
    from . import native as _native

    if _native.available():
        data = np.frombuffer(b"".join(seqs), dtype=np.uint8)
        offsets = np.zeros(n + 1, dtype=np.int64)
        np.cumsum([len(s) for s in seqs], out=offsets[1:])
        result = _native.extract_segment_kmers(data, offsets, k)
        if result is not None:
            return result
    lens = np.fromiter((len(s) for s in seqs), dtype=np.int64, count=n)
    if int(lens.min(initial=k)) < k:
        # rare (alleles shorter than k appear only with tiny test k):
        # route short segments through the scalar path
        kmer_parts = []
        seg_parts = []
        long_idx = [i for i in range(n) if lens[i] >= k]
        for i in range(n):
            if lens[i] >= k:
                continue
            km = rolling_kmers_with_final(seqs[i], k)
            kmer_parts.append(km)
            seg_parts.append(np.full(len(km), i, np.int32))
        if long_idx:
            lk, ls = flat_segment_kmers([seqs[i] for i in long_idx], k)
            kmer_parts.append(lk)
            seg_parts.append(np.asarray(long_idx, np.int32)[ls])
        kmers = np.concatenate(kmer_parts) if kmer_parts else np.empty(0, np.uint64)
        segs = np.concatenate(seg_parts) if seg_parts else np.empty(0, np.int32)
        order = np.argsort(segs, kind="stable")
        return kmers[order], segs[order]

    codes = encode_bases(b"".join(seqs))
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lens, out=offsets[1:])
    packed = pack_windows(np.where(codes > 3, 3, codes), k)
    invalid = (codes > 3).astype(np.int64)
    csum = np.concatenate([[0], np.cumsum(invalid)])
    window_has_n = (csum[k:] - csum[:-k]) > 0  # flat window validity

    w = lens - k + 1  # windows per segment
    W = int(w.sum())
    w_off = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(w, out=w_off[1:])
    seg_ids = np.repeat(np.arange(n, dtype=np.int32), w)
    # flat window index of each in-segment window
    idx = np.arange(W, dtype=np.int64) + np.repeat(
        offsets[:-1] - w_off[:-1], w
    )
    emit = ~window_has_n[idx]
    emit[w_off[1:] - 1] = True  # final window: unconditional
    return packed[idx[emit]], seg_ids[emit]
