"""ctypes bindings for the native k-mer engine (csrc/kmercount.cpp).

The shared library is compiled on first use with g++ -O3 into the
gitignored build directory (never next to the shared source, whose
committed binary was built for another host). A failed build or load
RAISES: a silent numpy fallback would be a hidden slowdown of the main
path.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import List, Optional, Tuple

import numpy as np

from .._build import BUILD_DIR, REPO_ROOT, build_once

_CSRC = os.path.join(REPO_ROOT, "csrc")
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def _build_and_load() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        src = os.path.join(_CSRC, "kmercount.cpp")
        so = os.path.join(BUILD_DIR, "libkmercount.so")
        build_once(
            src, so,
            lambda out: subprocess.run(
                ["g++", "-O3", "-march=native", "-shared", "-fPIC",
                 "-std=c++17", src, "-o", out],
                check=True, capture_output=True, text=True,
            ),
        )
        lib = ctypes.CDLL(so)

        u64p = ctypes.POINTER(ctypes.c_uint64)
        i64p = ctypes.POINTER(ctypes.c_int64)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.pg_extract_canonical.restype = ctypes.c_int64
        lib.pg_extract_canonical.argtypes = [
            u8p, i64p, ctypes.c_int64, ctypes.c_int, u64p
        ]
        lib.pg_extract_forward.restype = ctypes.c_int64
        lib.pg_extract_forward.argtypes = [
            u8p, i64p, ctypes.c_int64, ctypes.c_int, u64p
        ]
        lib.pg_count_sorted.restype = ctypes.c_int64
        lib.pg_count_sorted.argtypes = [u64p, ctypes.c_int64, u64p, i64p]
        lib.pg_lookup_sorted.restype = None
        lib.pg_lookup_sorted.argtypes = [
            u64p, i64p, ctypes.c_int64, u64p, ctypes.c_int64, i64p
        ]
        lib.pg_update_counts_sorted.restype = None
        lib.pg_update_counts_sorted.argtypes = [
            u64p, i64p, ctypes.c_int64, u64p, ctypes.c_int64
        ]
        lib.pg_stream_update_counts.restype = None
        lib.pg_stream_update_counts.argtypes = [
            u8p, i64p, ctypes.c_int64, ctypes.c_int, u64p, i64p,
            ctypes.c_int64
        ]
        lib.pg_hash_create.restype = ctypes.c_void_p
        lib.pg_hash_create.argtypes = [u64p, ctypes.c_int64]
        lib.pg_hash_destroy.restype = None
        lib.pg_hash_destroy.argtypes = [ctypes.c_void_p]
        u32p = ctypes.POINTER(ctypes.c_uint32)
        lib.pg_pack_2bit.restype = None
        lib.pg_pack_2bit.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_int64, u32p, u32p, ctypes.c_int,
        ]
        lib.pg_pack_rows.restype = None
        lib.pg_pack_rows.argtypes = [
            u8p, i64p, i64p, ctypes.c_int64, ctypes.c_int64, u32p, u32p,
            ctypes.c_int,
        ]
        lib.pg_hash_lookup.restype = None
        lib.pg_hash_lookup.argtypes = [
            ctypes.c_void_p, i64p, u64p, ctypes.c_int64, i64p,
            ctypes.c_int,
        ]
        lib.pg_hash_lookup_canon.restype = None
        lib.pg_hash_lookup_canon.argtypes = [
            ctypes.c_void_p, i64p, u64p, ctypes.c_int64, ctypes.c_int,
            i64p, ctypes.c_int,
        ]
        # hot per-VCF-line call: c_char_p lets Python bytes pass with
        # no data_as/cast object churn; the out pointer goes as a raw
        # address (ctypes .data int) via c_void_p
        lib.pg_parse_gt.restype = ctypes.c_int64
        lib.pg_parse_gt.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_void_p,
        ]
        lib.pg_hash_stream_update.restype = None
        lib.pg_hash_stream_update.argtypes = [
            ctypes.c_void_p, u8p, i64p, ctypes.c_int64, ctypes.c_int,
            i64p, ctypes.c_int
        ]
        lib.pg_hash_stream_update_sharded.restype = None
        lib.pg_hash_stream_update_sharded.argtypes = [
            ctypes.c_void_p, u8p, i64p, ctypes.c_int64, ctypes.c_int,
            i64p, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64,
        ]
        lib.pg_parse_fasta_chunk.restype = ctypes.c_int64
        lib.pg_parse_fasta_chunk.argtypes = [u8p, ctypes.c_int64, u8p, i64p]
        lib.pg_encode_bases.restype = None
        lib.pg_encode_bases.argtypes = [u8p, ctypes.c_int64, u8p]
        lib.pg_kc_create.restype = ctypes.c_void_p
        lib.pg_kc_create.argtypes = [u64p, ctypes.c_int64]
        lib.pg_kc_destroy.restype = None
        lib.pg_kc_destroy.argtypes = [ctypes.c_void_p]
        lib.pg_kc_stream_update.restype = None
        lib.pg_kc_stream_update.argtypes = [
            ctypes.c_void_p, u8p, i64p, ctypes.c_int64, ctypes.c_int,
            ctypes.c_int, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ]
        lib.pg_kc_export.restype = None
        lib.pg_kc_export.argtypes = [
            ctypes.c_void_p, u64p, ctypes.c_int64, i64p, ctypes.c_int,
        ]
        lib.pg_extract_segment_kmers.restype = ctypes.c_int64
        lib.pg_extract_segment_kmers.argtypes = [
            u8p, i64p, ctypes.c_int64, ctypes.c_int, u64p,
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.pg_sort_segments.restype = None
        lib.pg_sort_segments.argtypes = [
            u64p, i64p, ctypes.c_int64, ctypes.c_int,
        ]
        lib.pg_kv_sort_segments.restype = None
        lib.pg_kv_sort_segments.argtypes = [
            i64p, u64p, i64p, ctypes.c_int64, ctypes.c_int,
        ]
        i32p = ctypes.POINTER(ctypes.c_int32)
        u16p = ctypes.POINTER(ctypes.c_uint16)
        lib.pg_parse_vcf_chunk.restype = ctypes.c_int64
        lib.pg_parse_vcf_chunk.argtypes = [
            u8p, ctypes.c_int64,                       # buf, len
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int,  # samples, k, add_ref
            ctypes.c_int32,                            # n_chroms
            ctypes.POINTER(ctypes.c_char_p), i64p,     # chrom seqs, sizes
            u8p, i64p,                                 # names blob, offs
            ctypes.c_int32, ctypes.c_int64,            # prev chrom, prev end
            i32p, i64p, i64p,                          # chrom, start, end
            i64p, i32p,                                # alt off/len
            i64p, i32p,                                # id off/len
            i32p, u8p,                                 # nundef, newcluster
            u16p,                                      # paths
            i32p, i32p, ctypes.c_int64,                # nuncov, flat, cap
            i32p, i64p, i64p,                          # final chrom/end, bail
        ]
        _LIB = lib
        return _LIB


def available() -> bool:
    return _build_and_load() is not None


def _pack(seqs: List[bytes]) -> Tuple[np.ndarray, np.ndarray]:
    data = np.frombuffer(b"".join(seqs), dtype=np.uint8)
    offsets = np.zeros(len(seqs) + 1, dtype=np.int64)
    np.cumsum([len(s) for s in seqs], out=offsets[1:])
    return data, offsets


def extract_canonical_batch(seqs: List[bytes], k: int) -> Optional[np.ndarray]:
    """Canonical k-mers of every valid window across a sequence batch;
    None when the native library is unavailable."""
    lib = _build_and_load()
    if lib is None or not seqs:
        return None if lib is None else np.empty(0, dtype=np.uint64)
    data, offsets = _pack(seqs)
    out = np.empty(max(1, len(data)), dtype=np.uint64)
    n = lib.pg_extract_canonical(
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(seqs), k,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
    )
    return out[:n].copy()


def extract_canonical_raw(
    data: np.ndarray, offsets: np.ndarray, k: int
) -> Optional[np.ndarray]:
    """Canonical k-mers straight from a raw concatenated byte buffer +
    offsets (the parse_fasta_chunk layout) — no per-sequence Python
    bytes objects on the corpus-counting path."""
    lib = _build_and_load()
    if lib is None:
        return None
    data = np.ascontiguousarray(data, dtype=np.uint8)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    n_seqs = len(offsets) - 1
    if n_seqs <= 0:
        return np.empty(0, dtype=np.uint64)
    out = np.empty(max(1, len(data)), dtype=np.uint64)
    n = lib.pg_extract_canonical(
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n_seqs, k,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
    )
    return out[:n].copy()


def extract_segment_kmers(
    data: np.ndarray, offsets: np.ndarray, k: int
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Reference-semantics allele kmer enumeration (non-canonical,
    N-free body windows + unconditional final window) over a packed
    segment batch; None when native is unavailable."""
    lib = _build_and_load()
    if lib is None:
        return None
    data = np.ascontiguousarray(data, dtype=np.uint8)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    n_seqs = len(offsets) - 1
    cap = max(1, len(data) + n_seqs)
    kmers = np.empty(cap, dtype=np.uint64)
    segs = np.empty(cap, dtype=np.int32)
    n = lib.pg_extract_segment_kmers(
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n_seqs, k,
        kmers.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        segs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return kmers[:n].copy(), segs[:n].copy()


def sort_segments(
    values: np.ndarray, offsets: np.ndarray, n_threads: int = 0
) -> bool:
    """In-place per-segment ascending sort of a uint64 array; segments
    delimited by ``offsets``. False when native is unavailable."""
    lib = _build_and_load()
    if lib is None:
        return False
    assert values.dtype == np.uint64 and values.flags["C_CONTIGUOUS"]
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    if n_threads <= 0:
        n_threads = os.cpu_count() or 1
    lib.pg_sort_segments(
        values.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(offsets) - 1, n_threads,
    )
    return True


def kv_sort_segments(
    keys: np.ndarray, payload: np.ndarray, offsets: np.ndarray,
    n_threads: int = 0,
) -> bool:
    """STABLE in-place per-segment co-sort of (int64 key, uint64
    payload) pairs by key. False when native is unavailable."""
    lib = _build_and_load()
    if lib is None:
        return False
    assert keys.dtype == np.int64 and keys.flags["C_CONTIGUOUS"]
    assert payload.dtype == np.uint64 and payload.flags["C_CONTIGUOUS"]
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    if n_threads <= 0:
        n_threads = os.cpu_count() or 1
    lib.pg_kv_sort_segments(
        keys.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        payload.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(offsets) - 1, n_threads,
    )
    return True


def count_sorted(kmers: np.ndarray) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    lib = _build_and_load()
    if lib is None:
        return None
    kmers = np.ascontiguousarray(kmers, dtype=np.uint64)
    n = len(kmers)
    keys = np.empty(max(1, n), dtype=np.uint64)
    counts = np.empty(max(1, n), dtype=np.int64)
    m = lib.pg_count_sorted(
        kmers.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), n,
        keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return keys[:m].copy(), counts[:m].copy()


def lookup_sorted(
    keys: np.ndarray, counts: np.ndarray, queries: np.ndarray
) -> Optional[np.ndarray]:
    lib = _build_and_load()
    if lib is None:
        return None
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    counts = np.ascontiguousarray(counts, dtype=np.int64)
    queries = np.ascontiguousarray(queries, dtype=np.uint64)
    out = np.empty(max(1, len(queries)), dtype=np.int64)
    lib.pg_lookup_sorted(
        keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(keys),
        queries.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        len(queries),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return out[: len(queries)]


class KmerHashIndex:
    """Opaque handle to the native open-addressing key index; built
    once per counter and reused across read blocks."""

    def __init__(self, keys: np.ndarray):
        lib = _build_and_load()
        if lib is None:
            raise RuntimeError("native k-mer library unavailable")
        assert keys.dtype == np.uint64
        self._keys = keys  # keep alive (hash copies, but be safe)
        self._lib = lib
        self._handle = lib.pg_hash_create(
            keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), len(keys)
        )

    def stream_update(
        self, seqs: List[bytes], k: int, counts: np.ndarray,
        n_threads: int = 0,
    ) -> None:
        if not seqs:
            return
        assert counts.dtype == np.int64
        if n_threads <= 0:
            n_threads = os.cpu_count() or 1
        data, offsets = _pack(seqs)
        self._lib.pg_hash_stream_update(
            self._handle,
            data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(seqs), k,
            counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            n_threads,
        )

    def stream_update_raw(
        self, data: np.ndarray, offsets: np.ndarray, k: int,
        counts: np.ndarray, n_threads: int = 0,
        shard=None, base: int = 0,
    ) -> None:
        """Block-path update: raw concatenated sequence bytes +
        cumulative offsets (from parse_fasta_chunk), optional
        ``shard=(i, n)`` read partition applied in the native loop."""
        n_seqs = len(offsets) - 1
        if n_seqs <= 0:
            return
        assert counts.dtype == np.int64
        if n_threads <= 0:
            n_threads = os.cpu_count() or 1
        shard_i, shard_n = shard if shard is not None else (0, 1)
        self._lib.pg_hash_stream_update_sharded(
            self._handle,
            data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            n_seqs, k,
            counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            n_threads, shard_i, shard_n, base,
        )

    def lookup(self, queries: np.ndarray, counts: np.ndarray,
               n_threads: int = 0) -> np.ndarray:
        """Batched abundance lookup of canonical queries: ~2 hash
        probes each instead of log2(n) binary-search misses."""
        queries = np.ascontiguousarray(queries, dtype=np.uint64)
        counts = np.ascontiguousarray(counts, dtype=np.int64)
        out = np.empty(max(1, len(queries)), dtype=np.int64)
        if n_threads <= 0:
            n_threads = os.cpu_count() or 1
        self._lib.pg_hash_lookup(
            self._handle,
            counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            queries.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            len(queries),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            n_threads,
        )
        return out[: len(queries)]

    def lookup_canon(self, queries: np.ndarray, counts: np.ndarray,
                     k: int, n_threads: int = 0) -> np.ndarray:
        """Like :meth:`lookup`, but queries may be either strand: the
        canonical form is computed per probe in C (replacing a ~7-pass
        numpy canonicalization of the whole query array)."""
        queries = np.ascontiguousarray(queries, dtype=np.uint64)
        counts = np.ascontiguousarray(counts, dtype=np.int64)
        out = np.empty(max(1, len(queries)), dtype=np.int64)
        if n_threads <= 0:
            n_threads = os.cpu_count() or 1
        self._lib.pg_hash_lookup_canon(
            self._handle,
            counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            queries.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            len(queries), k,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            n_threads,
        )
        return out[: len(queries)]

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.pg_hash_destroy(handle)
            self._handle = None


class KmerCountTable:
    """Fused {key, count} open-addressing table for PRIME+UPDATE
    streaming: one random cache-line touch per counted window (the
    three-array KmerHashIndex layout cost ~3 DRAM misses per window),
    probes prefetched in batches of 16. Counts accumulate inside the
    table across stream calls and export once into sorted-key order."""

    def __init__(self, keys: np.ndarray):
        lib = _build_and_load()
        if lib is None:
            raise RuntimeError("native k-mer library unavailable")
        assert keys.dtype == np.uint64
        self._keys = keys
        self._lib = lib
        self._handle = lib.pg_kc_create(
            keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), len(keys)
        )

    def stream_update_raw(
        self, data: np.ndarray, offsets: np.ndarray, k: int,
        n_threads: int = 0, shard=None, base: int = 0,
    ) -> None:
        n_seqs = len(offsets) - 1
        if n_seqs <= 0:
            return
        if n_threads <= 0:
            n_threads = os.cpu_count() or 1
        shard_i, shard_n = shard if shard is not None else (0, 1)
        self._lib.pg_kc_stream_update(
            self._handle,
            data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            n_seqs, k, n_threads, shard_i, shard_n, base,
        )

    def stream_update(
        self, seqs: List[bytes], k: int, n_threads: int = 0
    ) -> None:
        if not seqs:
            return
        data, offsets = _pack(seqs)
        self.stream_update_raw(data, offsets, k, n_threads)

    def export_counts(self, n_threads: int = 0) -> np.ndarray:
        """Accumulated counts aligned with the constructor's keys."""
        out = np.zeros(max(1, len(self._keys)), dtype=np.int64)
        if n_threads <= 0:
            n_threads = os.cpu_count() or 1
        self._lib.pg_kc_export(
            self._handle,
            self._keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            len(self._keys),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            n_threads,
        )
        return out[: len(self._keys)]

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.pg_kc_destroy(handle)
            self._handle = None


def parse_fasta_chunk(chunk: bytes) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Parse a FASTA text chunk (starting and ending at record
    boundaries) into (data bytes, cumulative offsets); None when the
    native engine is unavailable."""
    lib = _build_and_load()
    if lib is None:
        return None
    text = np.frombuffer(chunk, dtype=np.uint8)
    n = len(text)
    data = np.empty(max(1, n), dtype=np.uint8)
    offsets = np.empty(chunk.count(b">") + 2, dtype=np.int64)
    n_seqs = lib.pg_parse_fasta_chunk(
        text.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n,
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return data, offsets[: n_seqs + 1]


def encode_bases_raw(data: np.ndarray) -> Optional[np.ndarray]:
    """Raw sequence bytes -> base codes via the native table; None when
    the native engine is unavailable."""
    lib = _build_and_load()
    if lib is None:
        return None
    data = np.ascontiguousarray(data, dtype=np.uint8)
    out = np.empty(max(1, len(data)), dtype=np.uint8)
    lib.pg_encode_bases(
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        len(data),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return out[: len(data)]


def stream_update_counts(
    seqs: List[bytes], k: int, keys: np.ndarray, counts: np.ndarray
) -> bool:
    """Fused extract + PRIME/UPDATE accumulation for a sequence batch;
    no intermediate k-mer arrays. False when the native lib is absent."""
    lib = _build_and_load()
    if lib is None:
        return False
    if not seqs or not len(keys):
        return True
    assert keys.dtype == np.uint64 and counts.dtype == np.int64
    data, offsets = _pack(seqs)
    lib.pg_stream_update_counts(
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(seqs), k,
        keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(keys),
    )
    return True


def update_counts_sorted(
    keys: np.ndarray, counts: np.ndarray, queries: np.ndarray
) -> bool:
    """Accumulate query hits into counts in place; False if no lib."""
    lib = _build_and_load()
    if lib is None:
        return False
    assert keys.dtype == np.uint64 and counts.dtype == np.int64
    queries = np.ascontiguousarray(queries, dtype=np.uint64)
    lib.pg_update_counts_sorted(
        keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(keys),
        queries.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        len(queries),
    )
    return True


def pack_rows(data: np.ndarray, starts: np.ndarray, lens: np.ndarray,
              L: int, n_threads: int = 0
              ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Encode + pack variable-length rows straight from the raw
    sequence byte buffer into the [B, ceil(L/16)] word / validity-mask
    device transfer format (csrc pg_pack_rows). Rows shorter than L
    get an invalid tail. None when the native engine is unavailable."""
    lib = _build_and_load()
    if lib is None:
        return None
    data = np.ascontiguousarray(data, dtype=np.uint8)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    lens = np.ascontiguousarray(lens, dtype=np.int64)
    B = len(starts)
    words = np.empty((B, (L + 15) // 16), np.uint32)
    vwords = np.empty((B, (L + 31) // 32), np.uint32)
    if n_threads <= 0:
        n_threads = min(os.cpu_count() or 1, 16)
    lib.pg_pack_rows(
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        B, L,
        words.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        vwords.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        n_threads,
    )
    return words, vwords


def parse_gt_line(gt_region: bytes, n_base_alleles: int,
                  n_samples: int) -> Optional[Tuple[np.ndarray, int]]:
    """Parse one VCF record's tab-separated phased GT region into
    2*n_samples path allele ids (csrc pg_parse_gt). Returns
    (paths, n_undefined) on success, None when the native engine is
    unavailable or the region needs the Python fallback (sample-count
    mismatch). Raises RuntimeError with PanGenie-compatible messages
    on malformed genotypes."""
    lib = _LIB
    if lib is None:
        lib = _build_and_load()
        if lib is None:
            return None
    out = np.empty(2 * n_samples, dtype=np.int32)
    rc = lib.pg_parse_gt(
        gt_region, len(gt_region), n_base_alleles, n_samples,
        out.ctypes.data,
    )
    if rc >= 0:
        return out, int(rc)
    if rc == -1:
        raise RuntimeError("PanelBuilder: found unphased genotype.")
    if rc == -2:
        raise RuntimeError(
            "PanelBuilder: genotypes must be diploid (.|. if missing)."
        )
    if rc == -3:
        raise RuntimeError("PanelBuilder: invalid genotype in VCF.")
    return None  # -4: let the caller's Python parser decide


class VcfChunkResult:
    """Arrays for the accepted records of one VCF body chunk."""

    __slots__ = (
        "n", "chrom", "start", "end", "alt_off", "alt_len", "id_off",
        "id_len", "nundef", "newcluster", "paths", "uncovered",
        "final_chrom", "final_end",
    )

    def __init__(self, n, chrom, start, end, alt_off, alt_len, id_off,
                 id_len, nundef, newcluster, paths, uncovered,
                 final_chrom, final_end):
        self.n = n
        self.chrom = chrom
        self.start = start
        self.end = end
        self.alt_off = alt_off
        self.alt_len = alt_len
        self.id_off = id_off
        self.id_len = id_len
        self.nundef = nundef
        self.newcluster = newcluster
        self.paths = paths
        self.uncovered = uncovered
        self.final_chrom = final_chrom
        self.final_end = final_end


def parse_vcf_chunk(
    chunk: bytes,
    n_samples: int,
    k: int,
    add_reference: bool,
    chrom_names: List[bytes],
    chrom_seqs: List[bytes],
    prev_chrom: int,
    prev_end: int,
) -> Optional[VcfChunkResult]:
    """Tokenize + validate a chunk of VCF data lines natively
    (csrc pg_parse_vcf_chunk). Returns None when the native engine is
    unavailable OR the chunk needs the Python reference parser (any
    anomaly: malformed line, would-be validation error, symbolic edge
    case the scanner does not model) — the caller must then re-parse
    with the exact-semantics Python path."""
    lib = _build_and_load()
    if lib is None:
        return None
    n_chroms = len(chrom_names)
    names_blob = b"".join(chrom_names)
    name_offs = np.zeros(n_chroms + 1, dtype=np.int64)
    np.cumsum([len(n) for n in chrom_names], out=name_offs[1:])
    seq_ptrs = (ctypes.c_char_p * n_chroms)(*chrom_seqs)
    sizes = np.asarray([len(s) for s in chrom_seqs], dtype=np.int64)

    n_lines = chunk.count(b"\n") + 1
    P2 = 2 * n_samples
    out_chrom = np.empty(n_lines, np.int32)
    out_start = np.empty(n_lines, np.int64)
    out_end = np.empty(n_lines, np.int64)
    out_alt_off = np.empty(n_lines, np.int64)
    out_alt_len = np.empty(n_lines, np.int32)
    out_id_off = np.empty(n_lines, np.int64)
    out_id_len = np.empty(n_lines, np.int32)
    out_nundef = np.empty(n_lines, np.int32)
    out_newcluster = np.empty(n_lines, np.uint8)
    out_paths = np.empty((n_lines, P2), np.uint16)
    out_nuncov = np.empty(n_lines, np.int32)
    final_chrom = np.empty(1, np.int32)
    final_end = np.empty(1, np.int64)
    bail = np.empty(1, np.int64)

    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    uncov_cap = 8 * n_lines + 1024
    while True:
        uncov_flat = np.empty(uncov_cap, np.int32)
        rc = lib.pg_parse_vcf_chunk(
            ctypes.cast(ctypes.c_char_p(chunk),
                        ctypes.POINTER(ctypes.c_uint8)),
            len(chunk), n_samples, k, 1 if add_reference else 0,
            n_chroms, seq_ptrs,
            sizes.ctypes.data_as(i64p),
            ctypes.cast(ctypes.c_char_p(names_blob),
                        ctypes.POINTER(ctypes.c_uint8)),
            name_offs.ctypes.data_as(i64p),
            prev_chrom, prev_end,
            out_chrom.ctypes.data_as(i32p),
            out_start.ctypes.data_as(i64p),
            out_end.ctypes.data_as(i64p),
            out_alt_off.ctypes.data_as(i64p),
            out_alt_len.ctypes.data_as(i32p),
            out_id_off.ctypes.data_as(i64p),
            out_id_len.ctypes.data_as(i32p),
            out_nundef.ctypes.data_as(i32p),
            out_newcluster.ctypes.data_as(
                ctypes.POINTER(ctypes.c_uint8)),
            out_paths.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
            out_nuncov.ctypes.data_as(i32p),
            uncov_flat.ctypes.data_as(i32p), uncov_cap,
            final_chrom.ctypes.data_as(i32p),
            final_end.ctypes.data_as(i64p),
            bail.ctypes.data_as(i64p),
        )
        if rc == -2:
            uncov_cap *= 4
            continue
        break
    if rc < 0:
        return None
    n = int(rc)
    # per-record uncovered lists; None when every record's is empty
    # (the overwhelmingly common case — caller uses fresh [] literals)
    counts = out_nuncov[:n]
    uncovered: Optional[List[List[int]]] = None
    if n and counts.any():
        offs = np.zeros(n + 1, np.int64)
        np.cumsum(counts, out=offs[1:])
        flat = uncov_flat[: offs[-1]].tolist()
        uncovered = [flat[offs[i]:offs[i + 1]] for i in range(n)]
    return VcfChunkResult(
        n, out_chrom[:n], out_start[:n], out_end[:n], out_alt_off[:n],
        out_alt_len[:n], out_id_off[:n], out_id_len[:n], out_nundef[:n],
        out_newcluster[:n], out_paths[:n], uncovered,
        int(final_chrom[0]), int(final_end[0]),
    )


def pack_2bit(codes: np.ndarray,
              n_threads: int = 0) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Threaded 2-bit + validity-bit packing of a [B, L] code batch
    (csrc pg_pack_2bit); None when the native engine is unavailable."""
    lib = _build_and_load()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    B, L = codes.shape
    words = np.empty((B, (L + 15) // 16), np.uint32)
    vwords = np.empty((B, (L + 31) // 32), np.uint32)
    if n_threads <= 0:
        n_threads = min(os.cpu_count() or 1, 16)
    lib.pg_pack_2bit(
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        B, L,
        words.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        vwords.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        n_threads,
    )
    return words, vwords
