"""Read k-mer counting on the device: kernels D1-extract, D1-count,
D1-route and D1-count-keys.

Port of ``pangenie_tpu/kmers/device_counter.py``. The count table
keeps the host engine's layout (counter.py): the graph k-mers as a
sorted array of canonical keys, a count beside each. Keys are int64: a
k-mer of k <= 31 fits 62 bits, so int64 order is the host's uint64
order.

- Sequences travel to the device packed, 2 bits a base plus a validity
  bit (0.375 bytes a base), as one flat stream a block
  (:func:`pack_sequences`, built by ``native.pack_rows``): no length
  buckets and no padded rows, at least one invalid base after each
  sequence so that no window spans two.
- Kernel D1-extract (``csrc/kmer_count.cu``) gives every window's
  canonical key; the table is built on the device from the path-segments
  FASTA in rounds of D1-extract, ``torch.sort`` and
  ``torch.unique_consecutive`` (:class:`PrimedDeviceCounter` without
  keys).
- Kernel D1-count extracts each read window's key, finds it by a
  directory of the key's top d bits, d sized to the table so a bucket
  holds a few keys (:func:`directory_bits`), reads the bucket's keys in
  16-byte pairs (narrowing a wide one by binary steps first), and adds
  one to its count with an atomic (the reference's sort-merge join was
  the TPU's answer to having no scatter). Counts are integers, so the
  result is exact in any order.
- :class:`DeviceKmerCounter` (COUNT mode) builds sorted count tables
  from D1-extract and library sorts.
- Over the ranks of a process group (``parallel/distributed.py``, one
  rank a card), :class:`ShardedPrimedDeviceCounter` hash-partitions the
  table: each rank holds the keys the reference's owner hash gives it.
  Each ingest step bins every read window's key by (owner, region) with
  kernel D1-route (:func:`route`: a stable counting sort, the region the
  key's top bits), sends each rank its bins (``all_to_all_single`` with
  exact sizes, the sizes of every bin first), and the receiver counts
  the keys in region order with kernel D1-count-keys (D1-count's search).
  :func:`sharded_count_kmers` and :func:`sharded_count_kmers_partitioned`
  are COUNT mode over the ranks.

On CPU tensors the wrappers :func:`extract`, :func:`count`,
:func:`route` and :func:`count_keys` run the plain versions
(:func:`extract_plain`, :func:`count_plain`, :func:`route_plain`,
:func:`count_keys_plain`); on CUDA tensors they launch the kernels or
raise.
"""

from __future__ import annotations

import ctypes
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .._build import CudaKernel, launch_stream
from ..device import resolve_device
from . import native

# the key of an invalid window (a valid key is below 4^31 = 2^62)
SENTINEL = (1 << 63) - 1
# D1-count reads a bucket of at most SCAN keys whole (csrc/kmer_count.cu:
# D1_SCAN, which pg_d1_scan answers)
SCAN = 4
# bases a packed piece: 2 words and 1 validity word (pack_sequences)
PIECE = 32
# device bytes a window of a table-building round may take (its key,
# the round's sort and its fold into the table): a round is the card's
# total memory over this
ROUND_BYTES_PER_WINDOW = 256
# keys whose owner a rank of the partitioned counter computes at a time
# (ShardedPrimedDeviceCounter: 512 MB of int64 keys, and their owners)
OWNER_CHUNK = 1 << 26
# D1-route: the keys a CTA takes at a time (csrc/kmer_count.cu: D1R_TILE)
# and the most bins (D1R_MAX_BINS, n_ranks << r counters in one CTA's
# shared memory). Each of its CTAs writes a contiguous range of keys into
# every bin, so CTAs x bins output lines are open at once: they are
# bounded by ROUTE_FRONTIER (lines a 50 MB L2 holds with room), but
# ROUTE_MIN_CTAS (two an H100 SM) fill the card (:func:`route_ctas`)
ROUTE_TILE = 1024
ROUTE_MAX_BINS = 1 << 14
ROUTE_FRONTIER = 1 << 17
ROUTE_MIN_CTAS = 264
ROUTE_MAX_CTAS = 2048
# the partitioned counter's region bits (:func:`region_bits`): a partition
# of n keys takes bit_length(n) - REGION_SHIFT, at most REGION_BITS. In
# `tools/d1_times.py --keys` (PERF.md, PR 20) D1-count-keys gained little
# past r = 4 on a partition of 15 M keys and fell to r = 8-12 on one of
# 700 M, while D1-route's time grew with r (0.56 ms at r = 0 to 1.90 at
# r = 8 on 40 M keys into 4 owners)
REGION_SHIFT = 20
REGION_BITS = 8
# the last count_file_primed_device's phase walls in seconds ("prime",
# "stream", "readback") and its launches ("blocks"), for the tools that
# time it (chip_smoke.py, tools/d1_times.py)
last_times: dict = {}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# kernel D1-extract: replaces pangenie_tpu/kmers/device_counter.py:extract_canonical
D1_EXTRACT = CudaKernel("kmer_count", "pg_d1_extract", "d1", [_P, _P, _L, _I, _P, _P])
# kernel D1-count: replaces lookup_pair_directed + primed_update_batch
# (and the sort-merge join primed_update_merge)
D1_COUNT = CudaKernel("kmer_count", "pg_d1_count", "d1",
                      [_P, _P, _L, _I, _P, _I, _P, _I, _P, _P])
# kernel D1-route: a block's keys binned by (owner, region), stably;
# replaces the binning of the reference's sharded ingest step
# (ShardedPrimedDeviceCounter._ingest_program) and the torch.sort route
D1_ROUTE = CudaKernel("kmer_count", "pg_d1_route", "d1",
                      [_P, _L, _I, _I, _I, _I, _P, _P, _P, _P, _P])
# kernel D1-count-keys: D1-count's search on keys already extracted (a
# partition's routed share, in region order); replaces the sharded
# counter's _flush_tagged
D1_COUNT_KEYS = CudaKernel("kmer_count", "pg_d1_count_keys", "d1",
                           [_P, _L, _I, _P, _I, _P, _I, _P, _P, _P, _I, _P])


# ---------------------------------------------------------------------------
# host packing
# ---------------------------------------------------------------------------


def pack_read_batch(
    seqs: List[bytes], length: Optional[int] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side: encode sequences to a padded [B, L] uint8 code array.

    Codes: A=0 C=1 G=2 T=3, invalid/padding=4.
    """
    from ..io.sequence import encode_bases

    if length is None:
        length = max((len(s) for s in seqs), default=0)
    batch = np.full((len(seqs), length), 4, dtype=np.uint8)
    for i, s in enumerate(seqs):
        codes = encode_bases(s[:length])
        batch[i, : len(codes)] = codes
    return batch, np.array([min(len(s), length) for s in seqs])


def pack_codes_2bit(codes: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side: [B, L] uint8 codes -> (words [B, ceil(L/16)] uint32,
    valid bitmask [B, ceil(L/32)] uint32), 2 bits and a validity bit a
    base (csrc pg_pack_2bit)."""
    return native.pack_2bit(codes)


def unpack_codes_2bit(words: np.ndarray, vwords: np.ndarray, L: int) -> torch.Tensor:
    """Inverse of :func:`pack_codes_2bit` -> [B, L] uint8 codes (4 where
    the validity bit is 0)."""
    B = words.shape[0]
    w = torch.from_numpy(words.astype(np.int64))
    v = torch.from_numpy(vwords.astype(np.int64))
    codes = ((w[:, :, None] >> 2 * torch.arange(16)) & 3).reshape(B, -1)[:, :L]
    valid = ((v[:, :, None] >> torch.arange(32)) & 1).reshape(B, -1)[:, :L]
    return torch.where(valid > 0, codes, 4).to(torch.uint8)


def pack_sequences(data: np.ndarray, starts: np.ndarray, lens: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray, int]:
    """The sequences data[starts[i]:starts[i] + lens[i]] as one flat
    block for D1: (words [T/16] uint32, vwords [T/32] uint32, T bases).

    Each sequence takes lens // PIECE + 1 pieces of PIECE bases, packed
    by ``native.pack_rows``; its last piece holds lens % PIECE bases and
    an invalid tail, so at least one invalid base follows every
    sequence and no window spans two."""
    starts = np.asarray(starts, dtype=np.int64)
    lens = np.asarray(lens, dtype=np.int64)
    pieces = lens // PIECE + 1
    total = int(pieces.sum())
    if total == 0:
        return np.zeros(0, np.uint32), np.zeros(0, np.uint32), 0
    seq = np.repeat(np.arange(len(lens)), pieces)
    offset = PIECE * (np.arange(total) - np.repeat(np.cumsum(pieces) - pieces, pieces))
    words, vwords = native.pack_rows(data, starts[seq] + offset, lens[seq] - offset, PIECE)
    return words.reshape(-1), vwords.reshape(-1), total * PIECE


def codes_block(codes: np.ndarray) -> Tuple[np.ndarray, np.ndarray, int, int]:
    """A [B, L] code batch as a flat block: every row padded with invalid
    codes to L' (the multiple of PIECE above L). Returns (words, vwords,
    B L', L'); row b's window j is the block's window b L' + j."""
    B, L = codes.shape
    width = (L // PIECE + 1) * PIECE
    padded = np.full((B, width), 4, dtype=np.uint8)
    padded[:, :L] = codes
    words, vwords = pack_codes_2bit(padded)
    return words.reshape(-1), vwords.reshape(-1), B * width, width


def _rows(starts: np.ndarray, lens: np.ndarray, k: int, max_row: int):
    """Sequences longer than ``max_row`` cut into rows of at most
    ``max_row`` bases overlapping by k - 1, so each window lies in one row."""
    if not len(lens) or lens.max() <= max_row:
        return starts, lens
    step = max_row - (k - 1)
    n_rows = np.where(lens > max_row, (lens - k) // step + 1, 1)
    seq = np.repeat(np.arange(len(lens)), n_rows)
    offset = step * (np.arange(int(n_rows.sum())) - np.repeat(np.cumsum(n_rows) - n_rows, n_rows))
    return starts[seq] + offset, np.minimum(max_row, lens[seq] - offset)


def _sequence_blocks(filename: str, block_bases: int):
    """(data, offsets) blocks of a FASTA or FASTQ file, gzipped or not:
    the native parser's raw blocks where it applies, else
    ``iter_sequences`` gathered into blocks of about ``block_bases``."""
    from .counter import iter_sequences, try_sequence_blocks

    blocks = try_sequence_blocks(filename)
    if blocks is not None:
        yield from blocks
        return
    batch: List[bytes] = []
    size = 0
    for seq in iter_sequences(filename):
        batch.append(seq)
        size += len(seq)
        if size >= block_bases:
            yield _joined(batch)
            batch, size = [], 0
    if batch:
        yield _joined(batch)


def _joined(seqs: List[bytes]) -> Tuple[np.ndarray, np.ndarray]:
    offsets = np.zeros(len(seqs) + 1, dtype=np.int64)
    np.cumsum([len(s) for s in seqs], out=offsets[1:])
    return np.frombuffer(b"".join(seqs), dtype=np.uint8), offsets


def packed_blocks(filenames: Sequence[str], k: int, block_bases: int, shard=None
                  ) -> Iterator[Tuple[np.ndarray, np.ndarray, int]]:
    """The sequences of ``filenames`` of at least k bases as flat blocks
    (:func:`pack_sequences`) of at most ``block_bases`` bases (at least
    4 pieces); a sequence longer than a block is cut into rows that
    overlap by k - 1. ``shard=(i, n)`` keeps every n-th sequence from the
    i-th, counted over the files' sequences (parallel/distributed.py)."""
    blocks = (block for filename in filenames
              for block in _sequence_blocks(filename, block_bases))
    return pack_blocks(blocks, k, block_bases, shard)


def pack_blocks(blocks, k: int, block_bases: int, shard=None
                ) -> Iterator[Tuple[np.ndarray, np.ndarray, int]]:
    """:func:`packed_blocks` of (data, offsets) blocks of sequences (the
    native FASTA parser's output): sequence i of a block is
    data[offsets[i]:offsets[i + 1]], as bytes."""
    shard_i, shard_n = shard if shard is not None else (0, 1)
    cap = max(4, block_bases // PIECE)
    max_row = (cap - 1) * PIECE
    base = 0
    for data, offsets in blocks:
        data = np.asarray(data, dtype=np.uint8)
        offsets = np.asarray(offsets, dtype=np.int64)
        lens = np.diff(offsets)
        keep = lens >= k
        if shard_n > 1:
            keep &= (base + np.arange(len(lens))) % shard_n == shard_i
        base += len(lens)
        starts, lens = _rows(offsets[:-1][keep], lens[keep], k, max_row)
        ends = np.cumsum(lens // PIECE + 1)
        i = 0
        while i < len(lens):
            j = int(np.searchsorted(ends, (ends[i - 1] if i else 0) + cap, side="right"))
            yield pack_sequences(data, starts[i:j], lens[i:j])
            i = j


def _on(device: torch.device, array: np.ndarray) -> torch.Tensor:
    """A uint32 numpy array as an int32 tensor (the same bits) on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(array).view(np.int32)).to(device)


# ---------------------------------------------------------------------------
# kernels and their plain versions
# ---------------------------------------------------------------------------


class Table(NamedTuple):
    """A sorted, unique int64 key table [n], 16-byte aligned, and its
    directory [2^d + 1] int32: bucket b (a key's top d bits, key >>
    shift) holds table[directory[b]:directory[b + 1]]."""

    keys: torch.Tensor
    directory: torch.Tensor
    shift: int

    @property
    def bits(self) -> int:
        """d, the directory's bits."""
        return (self.directory.shape[0] - 1).bit_length() - 1


def directory_bits(n_keys: int, k: int) -> int:
    """The directory's bits for a table of ``n_keys`` k-mers: floor(log2
    n), so a bucket holds 1-2 keys on average (24 at the 24-30 M keys of a
    20 Mb graph: 64 MB), at most 2k. D1-count's time fell with every step
    of d from 16 to 24 on 24-30 M keys, and rose past it (PERF.md)."""
    return min(2 * k, max(0, n_keys.bit_length() - 1))


def make_table(keys: torch.Tensor, k: int, d: Optional[int] = None) -> Table:
    """The :class:`Table` of sorted, unique int64 ``keys`` of k-mers, with
    a directory of ``d`` bits (default :func:`directory_bits`)."""
    if d is None:
        d = directory_bits(keys.shape[0], k)
    if not 0 <= d <= 2 * k:
        raise ValueError(f"a directory of {k}-mers takes 0 to {2 * k} bits, got {d}")
    if keys.data_ptr() % 16:
        keys = keys.clone()
    shift = 2 * k - d
    bounds = torch.arange((1 << d) + 1, dtype=torch.int64, device=keys.device) << shift
    return Table(keys, torch.searchsorted(keys, bounds, out_int32=True), shift)


def extract_plain(words: torch.Tensor, vwords: torch.Tensor, n_bases: int, k: int
                  ) -> torch.Tensor:
    """D1-extract's plain version: the canonical key of every window of
    a flat block, [n_bases] int64, SENTINEL where the window runs past
    the block or holds an invalid base."""
    dev = words.device
    p = torch.arange(n_bases, device=dev)
    w = words.to(torch.int64) & 0xFFFFFFFF
    v = vwords.to(torch.int64) & 0xFFFFFFFF
    codes = (w[p >> 4] >> (2 * (p & 15))) & 3
    bad = torch.zeros(n_bases + 1, dtype=torch.int64, device=dev)
    bad[1:] = torch.cumsum(((v[p >> 5] >> (p & 31)) & 1) ^ 1, 0)
    keys = torch.full((n_bases,), SENTINEL, dtype=torch.int64, device=dev)
    n_win = n_bases - k + 1
    if n_win <= 0:
        return keys
    fw = torch.zeros(n_win, dtype=torch.int64, device=dev)
    rc = torch.zeros(n_win, dtype=torch.int64, device=dev)
    for i in range(k):
        c = codes[i:i + n_win]
        fw = (fw << 2) | c
        rc |= (3 - c) << (2 * i)
    invalid = bad[k:] - bad[:n_win] > 0
    keys[:n_win] = torch.where(invalid, SENTINEL, torch.minimum(fw, rc))
    return keys


def lookup(table_keys: torch.Tensor, queries: torch.Tensor):
    """(index, found) of each query in the sorted table: the lower bound,
    clipped to the last entry, and whether the key is there (the
    reference's lookup_pair_sorted and lookup_pair_directed)."""
    n = table_keys.shape[0]
    if n == 0:
        return (torch.zeros(queries.shape, dtype=torch.int64, device=queries.device),
                torch.zeros(queries.shape, dtype=torch.bool, device=queries.device))
    idx = torch.searchsorted(table_keys, queries).clamp_(max=n - 1)
    return idx, table_keys[idx] == queries


def count_plain(words, vwords, n_bases: int, k: int, table: Table, counts: torch.Tensor
                ) -> None:
    """D1-count's plain version: adds each valid window's occurrence to
    ``counts`` [n] int32 where its key is in the table (in place)."""
    keys = extract_plain(words, vwords, n_bases, k)
    idx, found = lookup(table.keys, keys[keys != SENTINEL])
    hits = idx[found]
    counts.index_add_(0, hits, torch.ones(hits.shape, dtype=counts.dtype, device=counts.device))


def count_keys_plain(keys: torch.Tensor, table: Table, counts: torch.Tensor) -> None:
    """D1-count-keys' plain version: adds one to ``counts`` [n] int32 for
    each of ``keys`` found in the table (in place): :func:`lookup`, then
    ``index_add_``."""
    idx, found = lookup(table.keys, keys)
    hits = idx[found]
    counts.index_add_(0, hits, torch.ones(hits.shape, dtype=counts.dtype, device=counts.device))


def _check_block(words, vwords, n_bases: int, k: int):
    if not 1 <= k <= 31:
        raise ValueError(f"D1 takes k in [1, 31], got {k}")
    for name, t, per in (("words", words, 16), ("vwords", vwords, 32)):
        if t.dtype != torch.int32 or not t.is_contiguous() or t.dim() != 1:
            raise ValueError(f"D1: {name} must be a contiguous 1-d int32 tensor")
        if t.shape[0] < (n_bases + per - 1) // per:
            raise ValueError(f"D1: {name} holds fewer than {n_bases} bases")
    if vwords.device != words.device:
        raise ValueError("D1: words and vwords lie on different devices")


def extract(words: torch.Tensor, vwords: torch.Tensor, n_bases: int, k: int,
            kernel=D1_EXTRACT, stream=None) -> torch.Tensor:
    """Every window's canonical key, [n_bases] int64 (SENTINEL where
    invalid): kernel D1-extract on CUDA tensors, :func:`extract_plain` on
    CPU tensors. ``kernel`` and ``stream`` let the emulated test run the
    source's own entry point on CPU tensors."""
    _check_block(words, vwords, n_bases, k)
    if words.device.type == "cpu" and kernel is D1_EXTRACT:
        return extract_plain(words, vwords, n_bases, k)
    keys = torch.empty(n_bases, dtype=torch.int64, device=words.device)
    if n_bases:
        if stream is None:
            stream = launch_stream(words.device)
        kernel(words.data_ptr(), vwords.data_ptr(), n_bases, k, keys.data_ptr(), stream)
    return keys


def count(words: torch.Tensor, vwords: torch.Tensor, n_bases: int, k: int, table: Table,
          counts: torch.Tensor, kernel=D1_COUNT, stream=None) -> None:
    """Adds the block's windows found in ``table`` to ``counts`` [n]
    int32, in place: kernel D1-count on CUDA tensors,
    :func:`count_plain` on CPU tensors (``kernel``, ``stream``: as
    :func:`extract`)."""
    _check_block(words, vwords, n_bases, k)
    _check_table("D1-count", k, table, counts, words.device)
    if words.device.type == "cpu" and kernel is D1_COUNT:
        count_plain(words, vwords, n_bases, k, table, counts)
        return
    if n_bases:
        if stream is None:
            stream = launch_stream(words.device)
        kernel(words.data_ptr(), vwords.data_ptr(), n_bases, k, table.keys.data_ptr(),
               table.keys.shape[0], table.directory.data_ptr(), table.shift,
               counts.data_ptr(), stream)


def _check_table(what: str, k: int, table: Table, counts: torch.Tensor, device) -> None:
    n = table.keys.shape[0]
    d = table.bits
    for name, t, dtype, shape in (("table", table.keys, torch.int64, (n,)),
                                  ("directory", table.directory, torch.int32, ((1 << d) + 1,)),
                                  ("counts", counts, torch.int32, (n,))):
        if (t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous()
                or t.device != device):
            raise ValueError(f"{what}: {name} must be contiguous {dtype} {shape} on "
                             f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if table.shift != 2 * k - d or d > 2 * k:
        raise ValueError(f"{what}: the table's directory is not one of {k}-mers")
    if table.keys.data_ptr() % 16:
        raise ValueError(f"{what}: the table must be 16-byte aligned (make_table)")


def segments(m: int, runs: Optional[torch.Tensor], device) -> Tuple[torch.Tensor, torch.Tensor]:
    """D1-count-keys' segments of m keys received as ``runs`` [senders,
    regions] (each sender's keys in region order, its run's region
    sizes; None: one segment of all m keys): (seg_v [S + 1], seg_p [S]) int64,
    segment s = (region s // senders, sender s % senders) in
    region-major order, its keys at seg_p[s] of the received buffer and
    at seg_v[s] of the order D1-count-keys reads them in."""
    if runs is None:
        return (torch.tensor([0, m], dtype=torch.int64, device=device),
                torch.zeros(1, dtype=torch.int64, device=device))
    sizes = runs.to(device=device, dtype=torch.int64)
    flat = sizes.reshape(-1)
    physical = (torch.cumsum(flat, 0) - flat).view(sizes.shape)
    seg_v = torch.zeros(flat.shape[0] + 1, dtype=torch.int64, device=device)
    torch.cumsum(sizes.t().reshape(-1), 0, out=seg_v[1:])
    return seg_v, physical.t().contiguous().reshape(-1)


def _check_runs(m: int, runs: Optional[torch.Tensor]) -> None:
    """Raises unless ``runs`` (None, or [senders, regions]) are sizes of
    all m keys."""
    if runs is None:
        return
    if runs.dim() != 2 or runs.shape[0] < 1 or runs.shape[1] < 1:
        raise ValueError(f"D1-count-keys: runs must be [senders, regions], got "
                         f"{tuple(runs.shape)}")
    if int(runs.sum()) != m or bool((runs < 0).any()):
        raise ValueError(f"D1-count-keys: runs of {int(runs.sum())} keys for {m} keys")


def count_keys(keys: torch.Tensor, k: int, table: Table, counts: torch.Tensor,
               runs: Optional[torch.Tensor] = None, kernel=D1_COUNT_KEYS, stream=None) -> None:
    """Adds each of ``keys`` [m] int64 (k-mers, SENTINEL for none) found
    in ``table`` to ``counts`` [n] int32, in place: kernel D1-count-keys
    on CUDA tensors, :func:`count_keys_plain` on CPU tensors
    (``kernel``, ``stream``: as :func:`extract`). ``runs`` [senders,
    regions]: the keys as received from the senders of :func:`route`'s
    bins, each sender's run in region order, its sizes a region (the
    kernel reads them region-major over the senders; the counts are the
    same in any order)."""
    if not 1 <= k <= 31:
        raise ValueError(f"D1 takes k in [1, 31], got {k}")
    if keys.dtype != torch.int64 or keys.dim() != 1 or not keys.is_contiguous():
        raise ValueError("D1-count-keys: keys must be a contiguous 1-d int64 tensor")
    _check_table("D1-count-keys", k, table, counts, keys.device)
    _check_runs(keys.shape[0], runs)
    if keys.device.type == "cpu" and kernel is D1_COUNT_KEYS:
        count_keys_plain(keys, table, counts)
        return
    if keys.shape[0]:
        if stream is None:
            stream = launch_stream(keys.device)
        seg_v, seg_p = segments(keys.shape[0], runs, keys.device)
        kernel(keys.data_ptr(), keys.shape[0], k, table.keys.data_ptr(), table.keys.shape[0],
               table.directory.data_ptr(), table.shift, counts.data_ptr(), seg_v.data_ptr(),
               seg_p.data_ptr(), seg_p.shape[0], stream)


def route_bins(keys: torch.Tensor, k: int, n_ranks: int, r: int) -> torch.Tensor:
    """The bin of each of ``keys`` (k-mers of 2k bits): (owner << r) |
    region, the owner :func:`owner_of`'s, the region the key's top r of
    2k bits."""
    return (owner_of(keys, n_ranks) << r) | (keys >> (2 * k - r))


def route_plain(keys: torch.Tensor, k: int, n_ranks: int, r: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """D1-route's plain version: (the keys of 2k bits, SENTINEL and any
    other dropped, stably sorted by :func:`route_bins`; their counts a
    bin as [n_ranks, 2^r] int64)."""
    valid = keys[(keys >= 0) & (keys < (1 << 2 * k))]
    bins = route_bins(valid, k, n_ranks, r)
    order = torch.sort(bins, stable=True).indices
    sizes = torch.bincount(bins, minlength=n_ranks << r)
    return valid[order], sizes.view(n_ranks, 1 << r)


def route_ctas(m: int, bins: int) -> int:
    """D1-route's CTAs for m keys into ``bins`` bins: a tile of keys at
    least each; ROUTE_FRONTIER // bins, within ROUTE_MIN_CTAS and
    ROUTE_MAX_CTAS."""
    tiles = -(-m // ROUTE_TILE)
    return max(1, min(tiles, ROUTE_MAX_CTAS, max(ROUTE_MIN_CTAS, ROUTE_FRONTIER // bins)))


def region_bits(n_part: int, n_ranks: int, k: int) -> int:
    """The partitioned counter's region bits for partitions of about
    ``n_part`` keys: bit_length(n_part) - REGION_SHIFT, within 0 and
    REGION_BITS, at most 2k and at most what ROUTE_MAX_BINS leaves
    n_ranks owners. Every rank must take the same bits (a sender's bins
    are every owner's), so the caller passes a size all ranks agree on."""
    return max(0, min(n_part.bit_length() - REGION_SHIFT, REGION_BITS, 2 * k,
                      (ROUTE_MAX_BINS // n_ranks).bit_length() - 1))


def route(keys: torch.Tensor, k: int, n_ranks: int, r: int, kernel=D1_ROUTE, stream=None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A block's ``keys`` [m] int64 (D1-extract's, SENTINEL among them)
    binned for ``n_ranks`` owners and 2^r regions: (the keys of 2k bits
    in bin order, each bin's keys in their input order; the counts a bin
    [n_ranks, 2^r] int64). Kernel D1-route on CUDA tensors,
    :func:`route_plain` on CPU tensors (``kernel``, ``stream``: as
    :func:`extract`)."""
    if not 1 <= k <= 31:
        raise ValueError(f"D1 takes k in [1, 31], got {k}")
    if keys.dtype != torch.int64 or keys.dim() != 1 or not keys.is_contiguous():
        raise ValueError("D1-route: keys must be a contiguous 1-d int64 tensor")
    bins = n_ranks << r
    if n_ranks < 1 or not 0 <= r <= 2 * k or bins > ROUTE_MAX_BINS:
        raise ValueError(f"D1-route takes 1 to {ROUTE_MAX_BINS} bins of r <= 2k region "
                         f"bits, got {n_ranks} owners, r={r}, k={k}")
    if keys.shape[0] >= 1 << 31:
        raise ValueError("D1-route takes fewer than 2^31 keys")
    if keys.device.type == "cpu" and kernel is D1_ROUTE:
        return route_plain(keys, k, n_ranks, r)
    m = keys.shape[0]
    sizes = torch.zeros(bins, dtype=torch.int64, device=keys.device)
    if not m:
        return keys.new_empty(0), sizes.view(n_ranks, 1 << r)
    if stream is None:
        stream = launch_stream(keys.device)
    ctas = route_ctas(m, bins)
    out = torch.empty(m, dtype=torch.int64, device=keys.device)
    hist = torch.empty(ctas * bins, dtype=torch.int32, device=keys.device)
    starts = torch.empty(bins, dtype=torch.int64, device=keys.device)
    kernel(keys.data_ptr(), m, k, n_ranks, r, ctas, out.data_ptr(), sizes.data_ptr(),
           hist.data_ptr(), starts.data_ptr(), stream)
    return out[:int(sizes.sum())], sizes.view(n_ranks, 1 << r)


def search_steps(table: Table, keys: torch.Tensor, scan: int = SCAN) -> int:
    """The table reads D1-count makes for ``keys`` (extracted keys,
    SENTINEL for invalid windows), as its search makes them: for each
    valid window, the binary steps that narrow its bucket to at most
    ``scan`` keys (the library's D1_SCAN), then the pairs of keys that
    cover the rest from an even index (hmm/bounds.py: d1_count)."""
    keys = keys[keys != SENTINEL]
    d = table.directory.to(torch.int64)
    bucket = keys >> table.shift
    lo, hi = d[bucket], d[bucket + 1]
    steps = 0
    while True:
        wide = hi - lo > scan
        n_wide = int(wide.sum())
        if not n_wide:
            break
        steps += n_wide
        mid = lo + ((hi - lo) >> 1)
        below = table.keys[torch.where(wide, mid, 0)] <= keys
        lo = torch.where(wide & below, mid, lo)
        hi = torch.where(wide & ~below, mid, hi)
    # the pairs at even i, lo - 1 <= i < hi
    return steps + int((((hi + 1) >> 1) - (lo >> 1)).sum())


def extract_canonical(codes, k: int, device=None):
    """All canonical k-mer windows of a [B, L] code batch: (keys [B, W]
    int64, valid [B, W] bool), W = L - k + 1, through :func:`extract` on
    ``device`` (the reference's extract_canonical)."""
    dev = resolve_device(device)
    codes = np.asarray(codes, dtype=np.uint8)
    B, L = codes.shape
    W = L - k + 1
    assert W >= 1
    words, vwords, n_bases, width = codes_block(codes)
    keys = extract(_on(dev, words), _on(dev, vwords), n_bases, k).view(B, width)[:, :W]
    return keys, keys != SENTINEL


# ---------------------------------------------------------------------------
# count tables from library sorts
# ---------------------------------------------------------------------------


def count_kmers(keys: torch.Tensor, valid: torch.Tensor):
    """(sorted distinct keys, int64 counts) of the valid keys:
    ``torch.sort`` and ``torch.unique_consecutive``."""
    keys = keys.reshape(-1)[valid.reshape(-1)]
    distinct, counts = torch.unique_consecutive(torch.sort(keys).values, return_counts=True)
    return distinct, counts.to(torch.int64)


def merge_tables(a_keys, a_counts, b_keys, b_counts):
    """Two sorted count tables merged: concatenation, sort and a sum a
    distinct key."""
    keys, order = torch.sort(torch.cat([a_keys, b_keys]))
    distinct, inverse = torch.unique_consecutive(keys, return_inverse=True)
    counts = torch.zeros(distinct.shape, dtype=torch.int64, device=keys.device)
    return distinct, counts.index_add_(0, inverse, torch.cat([a_counts, b_counts])[order])


def histogram(counts: torch.Tensor, max_count: int, mask: Optional[torch.Tensor] = None):
    """count -> frequency histogram [max_count] of counts 1 .. max_count
    (clamped at max_count), over ``mask`` if given."""
    c = counts if mask is None else counts[mask]
    return torch.bincount(c.clamp(max=max_count), minlength=max_count + 1)[1:]


# ---------------------------------------------------------------------------
# PRIME+UPDATE counting
# ---------------------------------------------------------------------------


def round_windows(device: torch.device) -> int:
    """Windows a round of the table build takes: the card's total memory
    over ROUND_BYTES_PER_WINDOW (free memory varies with the caller's
    cache, so it sets nothing here); 2^24 on the CPU."""
    if device.type == "cuda":
        total = torch.cuda.get_device_properties(device).total_memory
        return max(1 << 20, total // ROUND_BYTES_PER_WINDOW)
    return 1 << 24


def footprint_bytes(n_keys: int, rounds: int, block_bases: int) -> int:
    """The most device bytes D1 holds for a table of ``n_keys``: the
    table and its counts (12 bytes a key) and directory (4 bytes a
    bucket of :func:`directory_bits`, at k = 31 the most), a block of
    packed reads (0.375 bytes a base), and a fold of the table build: a
    round's keys and their sort (32 bytes a window), the table with the
    round's keys and their sort (32 bytes an entry)."""
    return (12 * n_keys + 4 * ((1 << directory_bits(n_keys, 31)) + 1) + 3 * block_bases // 8
            + 32 * rounds + 32 * (n_keys + rounds))


def table_fits(n_keys: int, device: torch.device, block_bases: int) -> bool:
    """Whether D1's footprint for ``n_keys`` stays within 3/4 of the
    card's total memory (always on the CPU)."""
    if device.type != "cuda":
        return True
    total = torch.cuda.get_device_properties(device).total_memory
    return footprint_bytes(n_keys, round_windows(device), block_bases) <= total * 3 // 4


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class PrimedDeviceCounter:
    """PRIME+UPDATE counter on the device (src/jellyfishcounter.cpp:51-85):
    the graph k-mers as a sorted table with its directory and int32
    counts, all on the device; each block of packed reads goes through
    D1-count. With ``keys`` None the table is built on the device from
    ``corpus_files`` (:meth:`_prime_from_corpus`); ``round_windows``
    (default :func:`round_windows`) sizes its rounds."""

    def __init__(self, k: int, keys: Optional[np.ndarray] = None,
                 corpus_files: Sequence[str] = (), device=None,
                 round_windows: Optional[int] = None):
        if not (1 <= k <= 31):
            raise ValueError("PrimedDeviceCounter supports k in [1, 31].")
        self.k = k
        self.device = resolve_device(device)
        self.primed_on_device = keys is None
        if keys is None:
            table = self._prime_from_corpus(corpus_files, round_windows)
        else:
            keys = np.sort(np.asarray(keys, dtype=np.uint64))
            table = torch.from_numpy(keys.view(np.int64)).to(self.device)
        self.table = make_table(table, k)
        self.counts = torch.zeros(table.shape, dtype=torch.int32, device=self.device)

    @classmethod
    def from_reference_state(cls, k: int, hi: np.ndarray, lo: np.ndarray,
                             counts: np.ndarray, device=None) -> "PrimedDeviceCounter":
        """The counter whose table and counts are the reference's
        PrimedDeviceCounter's after a flush: its tagged key pairs (the
        key shifted left by one, split at bit 32) and int32 counts, as
        numpy."""
        keys = ((np.asarray(hi).astype(np.uint64) << np.uint64(32))
                | np.asarray(lo).astype(np.uint64)) >> np.uint64(1)
        counter = cls(k, keys, device=device)
        counter.counts.copy_(torch.from_numpy(np.array(counts[:len(keys)], dtype=np.int32)))
        return counter

    def _prime_from_corpus(self, corpus_files: Sequence[str],
                           rounds: Optional[int]) -> torch.Tensor:
        """The sorted, unique canonical k-mers of ``corpus_files``, built
        on the device: the corpus in rounds of at most ``rounds`` bases,
        each through D1-extract, its valid keys folded into the held
        table by ``torch.sort`` and ``torch.unique_consecutive`` (the
        reference's _dedupe_round)."""
        dev = self.device
        held = torch.empty(0, dtype=torch.int64, device=dev)
        for words, vwords, n_bases in packed_blocks(
                corpus_files, self.k, rounds or round_windows(dev)):
            keys = extract(_on(dev, words), _on(dev, vwords), n_bases, self.k)
            keys = torch.cat([held, keys[keys != SENTINEL]])
            held = torch.unique_consecutive(torch.sort(keys).values)
            del keys
        return held

    def update_block(self, words: np.ndarray, vwords: np.ndarray, n_bases: int) -> None:
        """Count one flat block (:func:`pack_sequences`) into the table."""
        if not len(self.table.keys) or not n_bases:
            return
        count(_on(self.device, words), _on(self.device, vwords), n_bases, self.k,
              self.table, self.counts)

    def update_batch(self, codes: np.ndarray) -> None:
        """Count one [B, L] uint8 code batch (:func:`pack_read_batch`)."""
        words, vwords, n_bases, _ = codes_block(np.asarray(codes, dtype=np.uint8))
        self.update_block(words, vwords, n_bases)

    def update_packed_batch(self, words: np.ndarray, vwords: np.ndarray,
                            length: int) -> None:
        """Count one batch in the reference's packed rows
        (:func:`pack_codes_2bit`), of ``length`` bases a row."""
        self.update_batch(unpack_codes_2bit(words, vwords, length).numpy())

    def to_host_arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        """(keys uint64, counts int64): the host counter's layout, every
        table key with its count, zero counts included."""
        keys = self.table.keys.cpu().numpy().view(np.uint64)
        return keys, self.counts.cpu().numpy().astype(np.int64)

    def to_exact_counter(self):
        from .counter import ExactKmerCounter

        keys, counts = self.to_host_arrays()
        keep = counts > 0
        return ExactKmerCounter(self.k, keys[keep], counts[keep])


def _prefetched(blocks: Iterator) -> Iterator:
    """``blocks`` with the next one parsed and packed on a host thread
    while the caller works on this one."""
    with ThreadPoolExecutor(max_workers=1) as pool:
        pending = pool.submit(next, blocks, None)
        while True:
            block = pending.result()
            if block is None:
                return
            pending = pool.submit(next, blocks, None)
            yield block


def count_file_primed_device(
    read_file: str,
    corpus_files,
    k: int,
    block_bases: int = 32 << 20,
    shard=None,
    keys: Optional[np.ndarray] = None,
    device=None,
):
    """PRIME+UPDATE counting of a read file on the device: the port's
    counterpart of ``ExactKmerCounter.count_file_primed``, with the same
    key set and counts (zero-count graph keys included).

    The table comes from ``keys`` or, where the caller holds none, is
    built on the device from ``corpus_files``. The reads stream as flat
    blocks of at most ``block_bases`` bases (the reference's jellyfish
    hash size ``-e`` sets it, as in ``commands._read_counter``), one
    D1-count launch a block; the next block is parsed and packed on a
    host thread while the device counts. ``shard=(process index,
    process count)`` keeps every n-th read (parallel/distributed.py).
    """
    from .counter import ExactKmerCounter

    t0 = time.monotonic()
    counter = PrimedDeviceCounter(k, keys, corpus_files=list(corpus_files), device=device)
    dev = counter.device
    if not len(counter.table.keys):
        return ExactKmerCounter(k, np.zeros(0, dtype=np.uint64), np.zeros(0, dtype=np.int64))
    _synchronize(dev)
    t_prime = time.monotonic()
    n_blocks = 0
    for block in _prefetched(packed_blocks([read_file], k, block_bases, shard)):
        counter.update_block(*block)
        n_blocks += 1
    _synchronize(dev)
    t_stream = time.monotonic()
    keys_out, counts = counter.to_host_arrays()
    last_times.update(prime=t_prime - t0, stream=t_stream - t_prime,
                      readback=time.monotonic() - t_stream, blocks=n_blocks)
    print(
        f"  [device counter] prime {t_prime - t0:.1f}s "
        f"(on_device={counter.primed_on_device}) "
        f"stream {t_stream - t_prime:.1f}s "
        f"flush+readback {last_times['readback']:.1f}s",
        file=sys.stderr,
    )
    return ExactKmerCounter(k, keys_out, counts)


# ---------------------------------------------------------------------------
# COUNT mode
# ---------------------------------------------------------------------------


class DeviceKmerCounter:
    """Batch-streaming device counter with host-compatible output: each
    batch's keys from D1-extract, counted by a sort and merged into the
    held table (:func:`count_kmers`, :func:`merge_tables`)."""

    def __init__(self, k: int, device=None):
        if not (1 <= k <= 31):
            raise ValueError("DeviceKmerCounter supports k in [1, 31].")
        self.k = k
        self.device = resolve_device(device)
        self._table = None  # (keys, counts) on the device

    def _add(self, keys: torch.Tensor, valid: torch.Tensor) -> None:
        table = count_kmers(keys, valid)
        self._table = table if self._table is None else merge_tables(*self._table, *table)

    def add_batch(self, codes: np.ndarray) -> None:
        """Count one [B, L] code batch and merge it into the table."""
        self._add(*extract_canonical(codes, self.k, self.device))

    def add_packed_batch(self, words: np.ndarray, vwords: np.ndarray, length: int) -> None:
        """Count one 2-bit packed batch (see :func:`pack_codes_2bit`)."""
        self.add_batch(unpack_codes_2bit(words, vwords, length).numpy())

    def to_host_arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        """(keys uint64, counts int64): the host counter's layout."""
        if self._table is None:
            return np.empty(0, np.uint64), np.empty(0, np.int64)
        keys, counts = self._table
        return keys.cpu().numpy().view(np.uint64), counts.cpu().numpy()

    def to_exact_counter(self):
        from .counter import ExactKmerCounter

        keys, counts = self.to_host_arrays()
        return ExactKmerCounter(self.k, keys, counts)


# ---------------------------------------------------------------------------
# over the ranks of a process group (parallel/distributed.py)
# ---------------------------------------------------------------------------


def _mul32(a, c: int):
    """(a * c) mod 2^32 for 0 <= a, c < 2^32, in int64 without overflow
    (numpy or torch): a's two 16-bit halves multiplied apart."""
    return (((((a >> 16) * c) & 0xFFFF) << 16) + (a & 0xFFFF) * c) & 0xFFFFFFFF


def _mix(hi, lo):
    """The reference's splitmix-style mix of a (hi, lo) pair of uint32
    words, its uint32 wraparound as int64 arithmetic masked to 32 bits."""
    return _mul32(hi ^ 0x9E3779B9, 0x85EBCA6B) ^ _mul32(lo, 0xC2B2AE35)


def _owner_mix(thi, tlo, n_dev):
    """Owner device of a tagged key: splitmix-style mix of the key bits
    (tag stripped, so graph and read forms of the same k-mer agree),
    mod device count. int64 numpy or torch, masked to 32 bits where the
    reference wraps around in uint32."""
    return _mix(thi, tlo & 0xFFFFFFFE) % n_dev


def owner_of(keys, n_ranks: int):
    """The rank that holds each int64 key (numpy or torch) among
    ``n_ranks``: :func:`_owner_mix` of the key tagged as the reference
    tags it (shifted left by one, split at bit 32), so a rank's
    partition is the reference's device partition."""
    tagged = keys << 1
    return _owner_mix(tagged >> 32, tagged & 0xFFFFFFFF, n_ranks)


def _route(keys: torch.Tensor, k: int, n_ranks: int, r: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exchange a block's ``keys`` (SENTINEL among them) so that each
    k-mer reaches its owner: binned by (owner, region) with
    :func:`route`, then every bin's size and the keys through
    ``all_to_all_single`` (``distributed.all_to_all_bins``). Returns the
    keys routed here, sender after sender, each sender's in region
    order, and their sizes [senders, 2^r] (D1-count-keys' ``runs``)."""
    from ..parallel import distributed as dist

    binned, sizes = route(keys, k, n_ranks, r)
    return dist.all_to_all_bins(binned, sizes)


def _route_by_owner(keys: torch.Tensor, owner: torch.Tensor, n_ranks: int) -> torch.Tensor:
    """COUNT mode's exchange: ``keys`` to the rank ``owner`` names,
    sorted by owner (``torch.sort``), counted by owner
    (``torch.bincount``), the sizes then the keys through
    ``all_to_all_single`` (``distributed.all_to_all_exact``). Returns
    the keys routed here."""
    from ..parallel import distributed as dist

    by_owner, order = torch.sort(owner, stable=True)
    sizes = torch.bincount(by_owner, minlength=n_ranks)
    return dist.all_to_all_exact(keys[order], sizes)


class ShardedPrimedDeviceCounter:
    """PRIME+UPDATE counting with the graph table hash-partitioned over
    the ranks' cards (port of the reference's class of the same name,
    whose partitions lie on one process's chips): a human graph holds
    about 2.5-3 G distinct 31-mers, more than one card's D1 table holds
    (``table_fits``), so each rank holds the keys whose owner
    (:func:`owner_of`) it is, as a D1 :class:`Table` with its own
    directory.

    Each ingest step (:meth:`update_block`, a collective: every rank
    calls it the same number of times, with an empty block where it has
    none) extracts the rank's read windows (D1-extract), bins the valid
    ones by owner and region (D1-route, ``region_bits`` of
    :func:`region_bits` for the partitions' mean size), sends each owner
    its bins (:func:`_route`) and
    counts what it received into the rank's partition in region order
    with D1-count-keys. The exchange carries exact sizes, so nothing is
    padded and nothing can overflow: the reference's [D, capacity] bins,
    slack, overflow error and ingest buffer have no counterpart.

    With ``keys`` None the partition is built on the card from
    ``corpus_files``, as :class:`PrimedDeviceCounter` builds its table,
    keeping the keys this rank owns.
    """

    def __init__(self, k: int, keys: Optional[np.ndarray] = None,
                 corpus_files: Sequence[str] = (), device=None,
                 round_windows: Optional[int] = None):
        from ..parallel import distributed as dist

        if not (1 <= k <= 31):
            raise ValueError("supports k in [1, 31]")
        self.k = k
        self.device = resolve_device(device)
        self.rank, self.n_ranks = dist.process_index(), dist.process_count()
        self.primed_on_device = keys is None
        if keys is None:
            part = self._prime_partition(corpus_files, round_windows)
        else:
            part = self._partition_of(np.sort(np.asarray(keys, dtype=np.uint64)).view(np.int64))
        self.table = make_table(part, k)
        self.counts = torch.zeros(part.shape, dtype=torch.int32, device=self.device)
        # the whole table's size, which every rank knows alike, sets the
        # route's regions
        total = int(dist.allreduce_sum(np.array([len(part)], dtype=np.int64))[0])
        self.region_bits = region_bits(total // self.n_ranks, self.n_ranks, k)

    def _partition_of(self, keys: np.ndarray) -> torch.Tensor:
        """The keys of the sorted int64 ``keys`` this rank owns, in order,
        on its card, their owners computed there a chunk of OWNER_CHUNK
        keys at a time (the whole table need not fit one card); each
        rank's count of keys goes to ``_per_dev``, as the reference
        keeps it."""
        parts = []
        self._per_dev = np.zeros(self.n_ranks, dtype=np.int64)
        for start in range(0, len(keys), OWNER_CHUNK):
            chunk = torch.from_numpy(keys[start:start + OWNER_CHUNK]).to(self.device)
            owner = owner_of(chunk, self.n_ranks)
            self._per_dev += torch.bincount(owner, minlength=self.n_ranks).cpu().numpy()
            parts.append(chunk[owner == self.rank])
            del chunk, owner
        return torch.cat(parts) if parts else torch.empty(0, dtype=torch.int64,
                                                           device=self.device)

    def _prime_partition(self, corpus_files: Sequence[str], rounds: Optional[int]
                         ) -> torch.Tensor:
        """The sorted, unique canonical k-mers of ``corpus_files`` this
        rank owns, built on the card in rounds (D1-extract, the owner's
        filter, ``torch.sort``, ``torch.unique_consecutive``)."""
        dev = self.device
        held = torch.empty(0, dtype=torch.int64, device=dev)
        for words, vwords, n_bases in packed_blocks(
                corpus_files, self.k, rounds or round_windows(dev)):
            keys = extract(_on(dev, words), _on(dev, vwords), n_bases, self.k)
            keys = keys[keys != SENTINEL]
            keys = torch.cat([held, keys[owner_of(keys, self.n_ranks) == self.rank]])
            held = torch.unique_consecutive(torch.sort(keys).values)
            del keys
        return held

    def update_block(self, words: np.ndarray, vwords: np.ndarray, n_bases: int) -> None:
        """One ingest step: this rank's flat block (:func:`pack_sequences`;
        ``n_bases`` 0 for none) through D1-extract, each valid key routed
        to its owner (D1-route), the keys routed here counted
        (D1-count-keys)."""
        dev = self.device
        keys = torch.empty(0, dtype=torch.int64, device=dev)
        if n_bases:
            keys = extract(_on(dev, words), _on(dev, vwords), n_bases, self.k)
        received, runs = _route(keys, self.k, self.n_ranks, self.region_bits)
        if len(self.table.keys):
            count_keys(received, self.k, self.table, self.counts, runs)

    def update_batch(self, codes: np.ndarray) -> None:
        """One ingest step on a [B, L] uint8 code batch (:func:`pack_read_batch`)."""
        words, vwords, n_bases, _ = codes_block(np.asarray(codes, dtype=np.uint8))
        self.update_block(words, vwords, n_bases)

    def to_host_arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        """(sorted keys uint64, counts int64) of the whole table, zero
        counts kept: every rank's partition gathered to the host a chunk
        at a time (``distributed.gather_to_host``, a collective) and put
        back in key order. Every read window of every rank is counted in
        it."""
        from ..parallel import distributed as dist

        keys = np.concatenate(dist.gather_to_host(self.table.keys))
        counts = np.concatenate(dist.gather_to_host(self.counts)).astype(np.int64)
        # the partitions are sorted runs: a stable sort merges them
        order = np.argsort(keys, kind="stable")
        return keys[order].view(np.uint64), counts[order]


def _ingest_all(counter: ShardedPrimedDeviceCounter, packed: Iterator) -> None:
    """Every flat block of ``packed`` (this rank's) through the counter's
    ingest steps. The ranks step together: while any rank has a block,
    each takes a step, with an empty block where it has run out."""
    from ..parallel import distributed as dist

    blocks = _prefetched(packed)
    empty = np.zeros(0, np.uint32)
    while True:
        block = next(blocks, None)
        if not dist.any_rank(block is not None):
            return
        counter.update_block(*(block if block is not None else (empty, empty, 0)))


def count_stream_sharded(read_blocks, k: int, keys: Optional[np.ndarray],
                         block_bases: int = 32 << 20, corpus_files: Sequence[str] = (),
                         device=None) -> ShardedPrimedDeviceCounter:
    """Drive a :class:`ShardedPrimedDeviceCounter` from this rank's
    (data, offsets) read blocks (the native FASTA parser's output), packed
    as flat blocks of at most ``block_bases`` bases (:func:`pack_blocks`:
    each read's windows once, none across reads, any length mix)."""
    counter = ShardedPrimedDeviceCounter(k, keys, corpus_files=corpus_files, device=device)
    _ingest_all(counter, pack_blocks(read_blocks, k, block_bases))
    return counter


def count_file_primed_sharded(
    read_file: str, k: int, keys: Optional[np.ndarray], shard=None,
    block_bases: int = 32 << 20, corpus_files: Sequence[str] = (), device=None,
):
    """File driver for the partitioned counter: PRIME+UPDATE a read file
    against a graph table hash-partitioned over the ranks' cards (given
    as ``keys``, or built from ``corpus_files``). ``shard=(i, n)`` (default:
    this rank's, every n-th read) picks the reads this rank streams.
    Returns an ExactKmerCounter with the whole table's key set (zero
    counts kept) and the counts of every rank's reads: the ranks' sum
    already, so no all-reduce follows."""
    from .counter import ExactKmerCounter
    from ..parallel import distributed as dist

    if shard is None:
        shard = (dist.process_index(), dist.process_count())
    t0 = time.monotonic()
    counter = ShardedPrimedDeviceCounter(k, keys, corpus_files=corpus_files, device=device)
    _ingest_all(counter, packed_blocks([read_file], k, block_bases, shard))
    keys_out, counts = counter.to_host_arrays()
    print(f"  [sharded device counter] rank {counter.rank}/{counter.n_ranks}: "
          f"{len(counter.table.keys)} of {len(keys_out)} keys, "
          f"{time.monotonic() - t0:.1f}s", file=sys.stderr)
    return ExactKmerCounter(k, keys_out, counts)


def sharded_count_kmers(codes: np.ndarray, k: int, device=None):
    """COUNT mode over the ranks: a [B, L] read batch (the same on every
    rank) split into contiguous row blocks, one a rank (padded with
    invalid rows as the reference pads); each rank counts its block
    (D1-extract, ``torch.sort``, ``torch.unique_consecutive``), then the
    partial tables are gathered (``all_gather``) and merged.

    Returns (sorted distinct keys int64, counts int64) on the rank's
    device, the same on every rank: the reference's table with its mask
    applied."""
    from ..parallel import distributed as dist

    local = _row_block(codes, dist.process_index(), dist.process_count())
    keys, counts = count_kmers(*extract_canonical(local, k, device))
    all_keys = torch.cat(dist.all_gather_varying(keys))
    all_counts = torch.cat(dist.all_gather_varying(counts))
    merged, order = torch.sort(all_keys)
    distinct, inverse = torch.unique_consecutive(merged, return_inverse=True)
    total = torch.zeros(distinct.shape, dtype=torch.int64, device=distinct.device)
    return distinct, total.index_add_(0, inverse, all_counts[order])


def sharded_count_kmers_partitioned(codes: np.ndarray, k: int, device=None):
    """COUNT mode over the ranks, hash-partitioned: each rank extracts its
    row block's k-mers, sends each to the rank the reference's mix of
    the untagged (hi, lo) key names (``all_to_all_single`` with exact
    sizes), and counts what it received. Each rank ends up holding a
    disjoint partition of the key space, so table memory scales 1/D.

    Returns this rank's partition: (sorted distinct keys int64, counts
    int64) on its device. Nothing can overflow, so the reference's
    ``slack`` and overflow count have no counterpart."""
    from ..parallel import distributed as dist

    n = dist.process_count()
    local = _row_block(codes, dist.process_index(), n)
    keys, valid = extract_canonical(local, k, device)
    keys = keys.reshape(-1)[valid.reshape(-1)]
    received = _route_by_owner(keys, _mix(keys >> 32, keys & 0xFFFFFFFF) % n, n)
    return count_kmers(received, torch.ones(received.shape, dtype=torch.bool,
                                            device=received.device))


def _row_block(codes: np.ndarray, i: int, n: int) -> np.ndarray:
    """Rank i's contiguous block of a [B, L] batch padded to a multiple of
    n rows with invalid codes (4)."""
    codes = np.asarray(codes, dtype=np.uint8)
    B = codes.shape[0]
    if B % n:
        codes = np.concatenate([codes, np.full((n - B % n,) + codes.shape[1:], 4, np.uint8)])
    per = codes.shape[0] // n
    return codes[i * per:(i + 1) * per]
