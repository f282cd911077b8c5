"""Canonical k-mer counting: sorted-table engine.

Replaces the Jellyfish boundary of the reference
(src/jellyfishcounter.cpp, src/kmercounter.hpp). Rather than a lock-free
hash (a CPU-threading design), the table is a SORTED ARRAY of canonical
k-mers plus a parallel count array:

- build  = extract + canonicalize + sort + run-length-encode
- lookup = binary search (vectorized searchsorted)
- merge  = merge-sorted + segment-sum (device-friendly; across TPU
  devices this becomes an all-gather + local merge)

This shape maps directly onto TPU primitives (``jax.lax.sort``,
``searchsorted``) — the device engine in ``device_counter.py`` uses the
identical layout so host and device tables are interchangeable and can
validate each other exactly.

Both jellyfish modes are provided (src/jellyfishcounter.cpp:26-85):
- COUNT: count all read k-mers.
- PRIME+UPDATE (the memory saver / default): first register the graph
  corpus k-mers with count 0, then add read k-mers only for registered
  keys.
"""

from __future__ import annotations

import gzip
import threading
from typing import Iterable, Iterator, List, Sequence

import numpy as np

import weakref

from . import native
from .histogram import Histogram, compute_kmer_coverage_from_peaks

# (keys buffer address, length) -> shared native hash index. The index
# holds its key array alive, so a live entry's address cannot be
# recycled; dead entries vanish with their last counter.
_HASH_INDEX_CACHE: "weakref.WeakValueDictionary" = weakref.WeakValueDictionary()
_HASH_INDEX_LOCK = threading.Lock()
from .mer import canonicalize, encode_kmer, enumerate_valid_kmers
from ..io.sequence import normalize_sequence


def iter_sequences(filename: str) -> Iterator[bytes]:
    """Yield sequences from FASTA or FASTQ (optionally gzipped)."""
    opener = gzip.open if filename.endswith(".gz") else open
    with opener(filename, "rt") as fh:
        first = fh.read(1)
        if not first:
            return
        if first == ">":
            fh.readline()  # rest of the first header line
            chunks: List[bytes] = []
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                if line.startswith(">"):
                    if chunks:
                        yield b"".join(chunks)
                    chunks = []
                else:
                    chunks.append(normalize_sequence(line))
            if chunks:
                yield b"".join(chunks)
        elif first == "@":
            # FASTQ: header already half-consumed; read 4-line records
            fh.readline()  # rest of header
            while True:
                seq = fh.readline().strip()
                if not seq:
                    return
                yield normalize_sequence(seq)
                fh.readline()  # +
                fh.readline()  # quals
                header = fh.readline()
                if not header:
                    return
        else:
            raise RuntimeError(f"iter_sequences: unrecognized format in {filename}")


def try_sequence_blocks(filename: str, block_bytes: int = 64 << 20):
    """Raw block FASTA streaming: yields (data bytes, cumulative
    offsets) numpy arrays parsed by the native C++ chunk parser —
    no per-read Python objects on the streaming path (a 3 GB 30x read
    set costs ~1e7 Python string allocations through iter_sequences).

    Returns None when the fast path does not apply (gzipped input,
    FASTQ, or no native library); callers fall back to
    :func:`iter_sequences`.
    """
    from . import native

    if filename.endswith(".gz") or not native.available():
        return None
    try:
        with open(filename, "rb") as fh:
            first = fh.read(1)
    except OSError:
        return None
    if first != b">":
        return None

    def gen():
        with open(filename, "rb") as fh:
            carry = b""
            while True:
                chunk = fh.read(block_bytes)
                if not chunk:
                    if carry:
                        yield native.parse_fasta_chunk(carry)
                    return
                buf = carry + chunk
                cut = buf.rfind(b"\n>")
                if cut == -1:
                    carry = buf  # record spans the block; keep growing
                    continue
                yield native.parse_fasta_chunk(buf[: cut + 1])
                carry = buf[cut + 1:]

    return gen()


class KmerCounter:
    """Abstract interface (reference src/kmercounter.hpp:9-24)."""

    def get_kmer_abundance(self, kmer) -> int:
        raise NotImplementedError

    def get_abundances(self, values: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def compute_kmer_coverage(self, genome_kmers: int) -> int:
        raise NotImplementedError

    def compute_histogram(
        self, max_count: int, largest_peak: bool, filename: str = ""
    ) -> int:
        raise NotImplementedError


class ExactKmerCounter(KmerCounter):
    """Sorted-table canonical k-mer counter."""

    def __init__(self, k: int, keys: np.ndarray, counts: np.ndarray):
        assert keys.dtype == np.uint64
        self.k = k
        self.keys = keys
        self.counts = counts

    # -- constructors ----------------------------------------------------

    @staticmethod
    def _extract_canonical(seqs: Iterable[bytes], k: int) -> np.ndarray:
        seq_list = seqs if isinstance(seqs, list) else list(seqs)
        result = native.extract_canonical_batch(seq_list, k)
        if result is not None:
            return result
        parts = []
        for seq in seq_list:
            kmers = enumerate_valid_kmers(seq, k)
            if len(kmers):
                parts.append(canonicalize(kmers, k))
        if not parts:
            return np.empty(0, dtype=np.uint64)
        return np.concatenate(parts)

    @classmethod
    def count_sequences(cls, seqs: Iterable[bytes], k: int) -> "ExactKmerCounter":
        """COUNT mode over an in-memory sequence iterable."""
        kmers = cls._extract_canonical(seqs, k)
        counted = native.count_sorted(kmers)
        if counted is not None:
            return cls(k, counted[0], counted[1])
        keys, counts = np.unique(kmers, return_counts=True)
        return cls(k, keys, counts.astype(np.int64))

    @classmethod
    def count_file(
        cls, filename: str, k: int, n_threads: int = 1,
        block_bases: int = 48 << 20,
    ) -> "ExactKmerCounter":
        """COUNT mode (jellyfish all-kmer counting) from FASTA/FASTQ.

        ``n_threads`` parallelizes the canonical-kmer extraction over
        raw sequence blocks (the ctypes call into the native engine
        releases the GIL, so host cores overlap — the reference gives
        its jellyfish `-t`/`-e` to this phase, src/commands.cpp:647);
        ``block_bases`` bounds each block (derived from the CLI's -e
        hash size by the index driver)."""
        if native.available():
            # blocks sized so a threaded run has >= 2 per worker
            raw_blocks = try_sequence_blocks(
                filename,
                block_bytes=int(
                    min(max(block_bases // max(1, 2 * n_threads), 1 << 22),
                        64 << 20)
                ),
            )
            if raw_blocks is not None:
                # raw-block path: native FASTA parse + extraction
                # straight off the byte buffers — no per-record Python
                # bytes; blocks extract concurrently when threaded
                from concurrent.futures import ThreadPoolExecutor

                def _extract(block):
                    data, offsets = block
                    return native.extract_canonical_raw(
                        np.asarray(data, dtype=np.uint8), offsets, k
                    )

                if n_threads > 1:
                    with ThreadPoolExecutor(max_workers=n_threads) as p:
                        parts = list(p.map(_extract, raw_blocks))
                else:
                    parts = [_extract(b) for b in raw_blocks]
                parts = [p for p in parts if p is not None and len(p)]
                kmers = (
                    np.concatenate(parts)
                    if parts
                    else np.empty(0, dtype=np.uint64)
                )
                counted = native.count_sorted(kmers)
                if counted is not None:
                    return cls(k, counted[0], counted[1])
                keys, counts = np.unique(kmers, return_counts=True)
                return cls(k, keys, counts.astype(np.int64))
        return cls.count_sequences(iter_sequences(filename), k)

    @classmethod
    def count_file_primed(
        cls, read_file: str, corpus_files: Sequence[str], k: int,
        n_threads: int = 0, shard=None, keys: np.ndarray = None,
    ) -> "ExactKmerCounter":
        """PRIME+UPDATE mode: track only k-mers present in the corpus.

        ``n_threads`` is the reference's `-j` jellyfish thread count
        (0 = all cores). ``shard=(process index, process count)``
        restricts the stream to every n-th read for multi-host runs —
        the caller sums the count vectors across processes
        (parallel/distributed.py). ``keys`` short-circuits the corpus
        extraction when the caller already holds the graph-kmer table.
        (reference src/jellyfishcounter.cpp:51-85)
        """
        if keys is None:
            corpus_kmers = []
            for f in corpus_files:
                corpus_kmers.append(
                    cls._extract_canonical(iter_sequences(f), k)
                )
            keys = np.unique(
                np.concatenate(corpus_kmers)
                if corpus_kmers
                else np.empty(0, dtype=np.uint64)
            )
        counts = np.zeros(len(keys), dtype=np.int64)
        if len(keys):
            raw_blocks = (
                try_sequence_blocks(read_file)
                if native.available() else None
            )
            if raw_blocks is not None:
                # fast path: native FASTA chunk parse + fused-table
                # streaming ({key,count} interleaved, double-buffered
                # prefetch pipeline: one random cache-line per window)
                # — zero Python work per read. The parse of block N+1
                # overlaps block N's (GIL-releasing) native streaming.
                from concurrent.futures import ThreadPoolExecutor

                kc = native.KmerCountTable(keys)
                base = 0
                with ThreadPoolExecutor(max_workers=1) as parse_pool:
                    it = iter(raw_blocks)
                    nxt = parse_pool.submit(lambda: next(it, None))
                    while True:
                        block = nxt.result()
                        if block is None:
                            break
                        nxt = parse_pool.submit(lambda: next(it, None))
                        data, offsets = block
                        kc.stream_update_raw(
                            data, offsets, k, n_threads, shard, base
                        )
                        base += len(offsets) - 1
                return cls(k, keys, kc.export_counts(n_threads))
            hash_index = (
                native.KmerHashIndex(keys) if native.available() else None
            )
            # stream reads in blocks; native extraction + accumulation
            from ..parallel.distributed import shard_sequences

            block: List[bytes] = []
            block_bases = 0
            for seq in shard_sequences(iter_sequences(read_file), shard):
                block.append(seq)
                block_bases += len(seq)
                if block_bases >= 32 * 1024 * 1024:
                    cls._accumulate_block(
                        keys, counts, block, k, hash_index, n_threads
                    )
                    block, block_bases = [], 0
            if block:
                cls._accumulate_block(
                    keys, counts, block, k, hash_index, n_threads
                )
        return cls(k, keys, counts)

    @classmethod
    def _accumulate_block(
        cls, keys: np.ndarray, counts: np.ndarray, block: List[bytes],
        k: int, hash_index=None, n_threads: int = 0,
    ) -> None:
        if hash_index is not None:
            hash_index.stream_update(block, k, counts, n_threads)
            return
        if native.stream_update_counts(block, k, keys, counts):
            return
        kmers = cls._extract_canonical(block, k)
        if not len(kmers):
            return
        idx = np.searchsorted(keys, kmers)
        idx_clip = np.minimum(idx, len(keys) - 1)
        mask = keys[idx_clip] == kmers
        np.add.at(counts, idx_clip[mask], 1)

    @classmethod
    def count_sequences_primed(
        cls, read_seqs: Iterable[bytes], corpus_seqs: Iterable[bytes], k: int
    ) -> "ExactKmerCounter":
        keys = np.unique(cls._extract_canonical(list(corpus_seqs), k))
        counts = np.zeros(len(keys), dtype=np.int64)
        if len(keys):
            cls._accumulate_block(keys, counts, list(read_seqs), k)
        return cls(k, keys, counts)

    # -- queries ---------------------------------------------------------

    def get_kmer_abundance(self, kmer) -> int:
        """Abundance of one k-mer (string or packed uint64); the query is
        canonicalized like JellyfishCounter::getKmerAbundance
        (src/jellyfishcounter.cpp:87-104).
        """
        if isinstance(kmer, (str, bytes)):
            value = np.array([encode_kmer(kmer)], dtype=np.uint64)
        else:
            value = np.array([kmer], dtype=np.uint64)
        return int(self.get_abundances(value)[0])

    _HASH_MIN_KEYS = 1 << 20  # below this, binary search wins

    def __getstate__(self):
        state = dict(self.__dict__)
        state.pop("_hash_index", None)  # ctypes handle: rebuilt lazily
        return state

    def _ensure_hash_index(self):
        """Build (once, under a lock — per-chromosome selection threads
        otherwise race and each pay the ~seconds-scale build) or fetch
        the shared open-addressing index for this key table."""
        hash_index = getattr(self, "_hash_index", None)
        if hash_index is not None:
            return hash_index
        with _HASH_INDEX_LOCK:
            hash_index = getattr(self, "_hash_index", None)
            if hash_index is not None:
                return hash_index
            cache_key = (
                self.keys.__array_interface__["data"][0],
                len(self.keys),
            )
            hash_index = _HASH_INDEX_CACHE.get(cache_key)
            if hash_index is None:
                hash_index = native.KmerHashIndex(self.keys)
                _HASH_INDEX_CACHE[cache_key] = hash_index
            self._hash_index = hash_index
        return hash_index

    def prepare_lookup_index(self) -> None:
        """Eagerly build the lookup index (overlaps with other host
        phases when called before the selection thread pool starts)."""
        if len(self.keys) >= self._HASH_MIN_KEYS and native.available():
            self._ensure_hash_index()

    def get_abundances(self, values: np.ndarray) -> np.ndarray:
        """Vectorized abundance lookup (values canonicalized here)."""
        if len(self.keys) == 0:
            return np.zeros(len(values), dtype=np.int64)
        if len(self.keys) >= self._HASH_MIN_KEYS and native.available():
            # big tables: amortize a one-time open-addressing index —
            # ~2 probes/query beats 20+ binary-search cache misses.
            # Counters sharing a key table (PRIME+UPDATE reuses the
            # graph counter's keys) share one index via the cache.
            # Canonicalization happens per probe in C.
            return self._ensure_hash_index().lookup_canon(
                np.asarray(values, dtype=np.uint64), self.counts, self.k
            )
        canon = canonicalize(np.asarray(values, dtype=np.uint64), self.k)
        result = native.lookup_sorted(self.keys, self.counts, canon)
        if result is not None:
            return result
        idx = np.searchsorted(self.keys, canon)
        idx_clip = np.minimum(idx, len(self.keys) - 1)
        found = self.keys[idx_clip] == canon
        return np.where(found, self.counts[idx_clip], 0).astype(np.int64)

    def compute_kmer_coverage(self, genome_kmers: int) -> int:
        """ceil(sum(counts)/genome_kmers) (src/jellyfishcounter.cpp:106-117)."""
        import math

        return int(math.ceil(float(np.sum(self.counts)) / float(genome_kmers)))

    def compute_histogram(
        self, max_count: int, largest_peak: bool, filename: str = ""
    ) -> int:
        """Histogram of non-zero counts -> smoothed peak -> coverage.

        (reference src/jellyfishcounter.cpp:119-153)
        """
        histogram = Histogram(max_count)
        nonzero = self.counts[self.counts > 0]
        histogram.add_counts(nonzero)
        if filename:
            histogram.write_to_file(filename)
        histogram.smooth_histogram()
        peak_ids, peak_values = histogram.find_peaks()
        estimate = compute_kmer_coverage_from_peaks(peak_ids, peak_values, largest_peak)
        if filename:
            with open(filename, "a") as out:
                out.write(f"parameters\t{estimate / 2.0:g}\t{estimate}\n")
        return estimate
