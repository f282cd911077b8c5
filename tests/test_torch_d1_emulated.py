"""Kernels D1-extract, D1-count and D1-count-keys of
``pangenie_tpu_torch/csrc/kmer_count.cu`` run on the CPU by an emulator
of the CUDA threads, through the real wrappers
(``device_counter.extract``, ``count`` and ``count_keys``), against
their plain versions on the same packed blocks or keys: the keys and
the counts must be equal.

The kernel source is compiled with g++ against the headers of
``tests/cuda_emulator/`` (each thread a fiber, blocks one after another;
an ``atomicAdd`` is a plain add, since fibers are cooperative), and the
one textual substitution makes the launch run every thread of every
block. So the kernels' indexing, funnel shifts, directory search and
bounds run as written; their timing is not modelled. Blocks whose words
end where an unreadable page begins show any load past them, and a
table whose neighbour in memory is a read's key shows a pair read past
its end.
``tests/test_torch_cuda_kernels.py`` holds the real kernels against the
plain versions on the card.
"""

import ctypes
import mmap
import os
import re
import subprocess

import numpy as np
import pytest
import torch

from pangenie_tpu_torch import _build
from pangenie_tpu_torch.kmers import device_counter as dc
from pangenie_tpu_torch.kmers.counter import ExactKmerCounter

HERE = os.path.dirname(os.path.abspath(__file__))
CPU = torch.device("cpu")
STREAM = ctypes.c_void_p(0)
KS = [1, 2, 15, 16, 17, 31]
# test-only entry points appended to the emulated source: the intrinsics
# the kernels use, as the emulator gives them
INTRINSICS = """
extern "C" unsigned t_funnelshift_r(unsigned lo, unsigned hi, unsigned s) {
    return __funnelshift_r(lo, hi, s);
}
extern "C" unsigned long long t_brevll(unsigned long long x) { return __brevll(x); }
extern "C" long long t_ldg(const long long* p, int pair) {
    if (!pair) return __ldg(p);
    const longlong2 v = __ldg(reinterpret_cast<const longlong2*>(p));
    return v.x - v.y;
}
"""


def _emulated_library(out, defines=()):
    """csrc/kmer_count.cu built against the emulator with ``defines``
    into ``out`` and loaded: its entry points bound and checked (a call
    that returns a CUDA error fails the test)."""
    with open(os.path.join(_build.CUDA_SRC_DIR, "kmer_count.cu")) as f:
        text, n = re.subn(
            r"kernel<<<\(unsigned\)blocks, threads, shared, \(cudaStream_t\)stream>>>\(args\.\.\.\);",
            "if (emu_run((int)blocks, threads, shared, [&]() { kernel(args...); }))"
            " return (int)cudaErrorInvalidValue;", f.read())
    assert n == 1, "the launch in csrc/kmer_count.cu changed"
    (out / "kmer_count.cpp").write_text(text + INTRINSICS)
    lib_path = out / "libkmer_count.so"
    subprocess.run(
        ["g++", "-std=c++17", "-O1", "-shared", "-fPIC", "-I",
         os.path.join(HERE, "cuda_emulator"), *(f"-D{d}" for d in defines), "-o", str(lib_path),
         os.path.join(HERE, "cuda_emulator", "emu.cpp"), str(out / "kmer_count.cpp")],
        check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    bound = {}
    for name, kernel in (("extract", dc.D1_EXTRACT), ("count", dc.D1_COUNT),
                         ("count_keys", dc.D1_COUNT_KEYS), ("route", dc.D1_ROUTE)):
        fn = getattr(lib, kernel.symbol)
        fn.argtypes = kernel._argtypes
        fn.restype = ctypes.c_int

        def call(*args, fn=fn):
            code = fn(*args)
            assert code == 0, f"emulated launch returned {code}"
        call.raw = fn
        bound[name] = call
    for name, args, res in (("t_funnelshift_r", [ctypes.c_uint] * 3, ctypes.c_uint),
                            ("t_brevll", [ctypes.c_ulonglong], ctypes.c_ulonglong),
                            ("t_ldg", [ctypes.c_void_p, ctypes.c_int], ctypes.c_longlong),
                            ("pg_d1_scan", [], ctypes.c_int), ("pg_d1_kpt", [], ctypes.c_int)):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, res
        bound[name] = fn
    return bound


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """csrc/kmer_count.cu as the card builds it, on the emulator."""
    return _emulated_library(tmp_path_factory.mktemp("d1_emulated"))


@pytest.fixture(scope="module", params=[3, 8])
def emulated_kpt(request, tmp_path_factory):
    """Builds with D1_KPT = 3 and 8 keys a thread of D1-count-keys (the
    card's build takes 1)."""
    bound = _emulated_library(tmp_path_factory.mktemp(f"d1_kpt{request.param}"),
                   [f"D1_KPT={request.param}"])
    assert bound["pg_d1_kpt"]() == request.param
    return bound


def _reads(seed, n, short=0):
    """n reads of 1-90 bases (6% N), ``short`` of them shorter than 31."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(31, 91, n)
    lens[:short] = rng.integers(1, 31, short)
    return [bytes(rng.choice(list(b"ACGTN"), int(n_), p=[.235] * 4 + [.06]).astype(np.uint8))
            for n_ in lens]


def _block(seqs):
    """The reads as one flat block on the CPU: (words, vwords, T)."""
    offsets = np.zeros(len(seqs) + 1, dtype=np.int64)
    np.cumsum([len(s) for s in seqs], out=offsets[1:])
    data = np.frombuffer(b"".join(seqs), dtype=np.uint8)
    words, vwords, n_bases = dc.pack_sequences(data, offsets[:-1], np.diff(offsets))
    return dc._on(CPU, words), dc._on(CPU, vwords), n_bases


def _emulated_keys(emulated, words, vwords, n_bases, k):
    return dc.extract(words, vwords, n_bases, k, kernel=emulated["extract"], stream=STREAM)


def _both_counts(emulated, words, vwords, n_bases, k, table):
    got = torch.zeros(table.keys.shape, dtype=torch.int32)
    dc.count(words, vwords, n_bases, k, table, got, kernel=emulated["count"], stream=STREAM)
    want = torch.zeros_like(got)
    dc.count_plain(words, vwords, n_bases, k, table, want)
    return got, want


@pytest.mark.parametrize("k", [1, 5, 11, 31])
def test_emulated_extract_matches_plain(emulated, k):
    """Windows across word boundaries (reads start anywhere in a word),
    N's, reads shorter than k, the block's last windows: the same keys
    as the plain version, whose valid keys are the host engine's."""
    seqs = _reads(k, 150, short=20)
    words, vwords, n_bases = _block(seqs)
    got = _emulated_keys(emulated, words, vwords, n_bases, k)
    want = dc.extract_plain(words, vwords, n_bases, k)
    assert torch.equal(got, want)
    host = np.sort(ExactKmerCounter._extract_canonical(seqs, k))
    assert np.array_equal(np.sort(want[want != dc.SENTINEL].numpy().view(np.uint64)), host)
    # a block cut inside a word: its last k - 1 windows run past the end
    cut = n_bases - 7
    assert torch.equal(_emulated_keys(emulated, words, vwords, cut, k),
                       dc.extract_plain(words, vwords, cut, k))


@pytest.mark.parametrize("k", [1, 5, 11, 31])
def test_emulated_count_matches_plain(emulated, k):
    """Counts into a table of every third read key plus keys no read
    has, against the plain version and the host engine's primed counts."""
    seqs = _reads(100 + k, 150, short=20)
    words, vwords, n_bases = _block(seqs)
    host = ExactKmerCounter._extract_canonical(seqs, k)
    rng = np.random.default_rng(k)
    extra = rng.integers(0, 4 ** k, 50, dtype=np.uint64)
    keys = np.unique(np.concatenate([host[::3], extra]))
    table = dc.make_table(torch.from_numpy(keys.view(np.int64)), k)
    got, want = _both_counts(emulated, words, vwords, n_bases, k, table)
    assert torch.equal(got, want)
    primed = ExactKmerCounter(k, keys, np.zeros(len(keys), np.int64))
    uniq, cnt = np.unique(host, return_counts=True)
    expected = np.zeros(len(keys), np.int64)
    expected[np.searchsorted(keys, uniq[np.isin(uniq, keys)])] = cnt[np.isin(uniq, keys)]
    assert np.array_equal(got.numpy(), expected) and len(primed.keys) == len(keys)
    assert got.sum() > 0


def test_emulated_count_into_an_empty_table(emulated):
    """An empty table: the search finds nothing and writes nothing."""
    words, vwords, n_bases = _block(_reads(3, 40))
    table = dc.make_table(torch.zeros(0, dtype=torch.int64), 31)
    got, want = _both_counts(emulated, words, vwords, n_bases, 31, table)
    assert got.shape == (0,) and want.shape == (0,)


@pytest.mark.parametrize("k", [16, 31])
def test_emulated_count_in_the_last_directory_bucket(emulated, k):
    """A key whose top 16 bits are all ones (the last directory bucket
    at d = 16 and at the rule's d: eight T's first, T...TA...A, whose
    reverse complement starts with as many) and the key 0 (the first),
    counted from reads that hold them."""
    half = k // 2
    last = b"T" * (k - half) + b"A" * half
    seqs = [last, b"C" + last + b"G", b"A" * k, last + b"N" + last]
    words, vwords, n_bases = _block(seqs)
    keys = np.unique(ExactKmerCounter._extract_canonical(seqs, k))
    for d in (min(16, 2 * k), dc.directory_bits(len(keys), k)):
        table = dc.make_table(torch.from_numpy(keys.view(np.int64)), k, d)
        assert (table.keys[-1] >> table.shift).item() == (1 << d) - 1
        got, want = _both_counts(emulated, words, vwords, n_bases, k, table)
        assert torch.equal(got, want)
        assert got[-1].item() == 4 and got[0].item() == 1


def test_emulated_extract_of_a_code_batch(emulated):
    """A [B, L] code batch laid out by codes_block: row b's windows are
    the block's b L' + j, as extract_canonical reads them."""
    rng = np.random.default_rng(12)
    codes = rng.choice(5, size=(6, 70), p=[.245] * 4 + [.02]).astype(np.uint8)
    words, vwords, n_bases, width = dc.codes_block(codes)
    words, vwords = dc._on(CPU, words), dc._on(CPU, vwords)
    got = _emulated_keys(emulated, words, vwords, n_bases, 21).view(6, width)[:, :50]
    want, valid = dc.extract_canonical(codes, 21, device="cpu")
    assert torch.equal(got, want) and valid.any()


# -- the funnel-shift windows and the sized directory ------------------------

_libc = ctypes.CDLL(None, use_errno=True)
_libc.mprotect.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int]


def _guarded(array):
    """``array``'s 32-bit words as an int32 tensor in memory that ends
    where an unreadable page begins: a load past its end faults."""
    array = np.ascontiguousarray(array).view(np.int32)
    page = mmap.PAGESIZE
    size = -(-max(array.nbytes, 1) // page) * page + page
    buf = mmap.mmap(-1, size)
    base = ctypes.addressof(ctypes.c_char.from_buffer(buf))
    assert _libc.mprotect(base + size - page, page, mmap.PROT_NONE if hasattr(
        mmap, "PROT_NONE") else 0) == 0
    view = np.frombuffer(buf, dtype=np.int32, count=len(array),
                         offset=size - page - array.nbytes)
    view[:] = array
    return torch.from_numpy(view)


def _exact_block(codes):
    """One row of codes (0-3, 4 invalid) as a block whose words and
    vwords hold exactly ceil(T/16) and ceil(T/32) words, guarded."""
    words, vwords = dc.pack_codes_2bit(np.asarray(codes, dtype=np.uint8)[None])
    assert words.shape[1] == -(-len(codes) // 16) and vwords.shape[1] == -(-len(codes) // 32)
    return _guarded(words[0]), _guarded(vwords[0]), len(codes)


def _codes(rng, shape, n_rate=0.0):
    return rng.choice(5, size=shape, p=[(1 - n_rate) / 4] * 4 + [n_rate]).astype(np.uint8)


def test_scan_mirrored(emulated):
    """``device_counter.SCAN``, which ``search_steps`` and the bound read,
    is the source's D1_SCAN (``pg_d1_scan``)."""
    assert emulated["pg_d1_scan"]() == dc.SCAN


def test_emulator_funnelshift_r_is_its_definition(emulated):
    """__funnelshift_r(lo, hi, s): the low 32 bits of hi:lo shifted right
    by s mod 32."""
    rng = np.random.default_rng(7)
    for lo, hi, s in zip(*(rng.integers(0, 1 << 32, 200, dtype=np.uint64) for _ in "ab"),
                         rng.integers(0, 64, 200)):
        lo, hi, s = int(lo), int(hi), int(s)
        assert emulated["t_funnelshift_r"](lo, hi, s) == ((hi << 32 | lo) >> (s & 31)) & (
            (1 << 32) - 1)


def test_emulator_brevll_is_its_definition(emulated):
    """__brevll(x): bit i of x at bit 63 - i."""
    rng = np.random.default_rng(8)
    for x in [0, 1, 3, 1 << 63, (1 << 64) - 1,
              *map(int, rng.integers(0, 1 << 64, 200, dtype=np.uint64))]:
        assert emulated["t_brevll"](x) == int(format(x, "064b")[::-1], 2)


def test_emulator_ldg_is_a_load(emulated):
    """__ldg of an int64 and of a 16-byte pair returns what memory holds."""
    t = torch.tensor([5, -(1 << 40), 123, 7], dtype=torch.int64)
    assert t.data_ptr() % 16 == 0
    assert emulated["t_ldg"](t.data_ptr() + 8, 0) == -(1 << 40)
    assert emulated["t_ldg"](t.data_ptr(), 1) == 5 + (1 << 40)
    assert emulated["t_ldg"](t.data_ptr() + 16, 1) == 123 - 7


@pytest.mark.parametrize("k", KS)
def test_emulated_windows_at_every_offset(emulated, k):
    """Windows that start at every base offset mod 16 and mod 32 (each
    spans two or three words and one or two validity words), in blocks
    of several lengths: the plain version's keys, and its counts into a
    table of every other key."""
    rng = np.random.default_rng(300 + k)
    for T in (512 + k, 517 + 2 * k, 543 + k):
        words, vwords, T = _exact_block(_codes(rng, T, 0.01))
        got = _emulated_keys(emulated, words, vwords, T, k)
        want = dc.extract_plain(words, vwords, T, k)
        assert torch.equal(got, want)
        valid = torch.nonzero(want != dc.SENTINEL).flatten()
        assert set((valid % 32).tolist()) == set(range(32))
        table = dc.make_table(torch.unique(want[valid])[::2].contiguous(), k)
        got_counts, want_counts = _both_counts(emulated, words, vwords, T, k, table)
        assert torch.equal(got_counts, want_counts) and got_counts.sum() > 0


@pytest.mark.parametrize("k", KS)
def test_emulated_invalid_base_at_each_position(emulated, k):
    """One invalid base in an otherwise valid row, at 32 offsets: exactly
    the k windows that hold it (at each of their positions) are invalid,
    as in the plain version."""
    rng = np.random.default_rng(400 + k)
    L = 2 * k + 64
    codes = _codes(rng, (32, L))
    at = k + 16 + np.arange(32)
    codes[np.arange(32), at] = 4
    words, vwords, T, width = dc.codes_block(codes)
    words, vwords = dc._on(CPU, words), dc._on(CPU, vwords)
    got = _emulated_keys(emulated, words, vwords, T, k)
    assert torch.equal(got, dc.extract_plain(words, vwords, T, k))
    for row, q in zip(got.view(32, width), at):
        invalid = torch.nonzero(row[:L - k + 1] == dc.SENTINEL).flatten()
        assert invalid.tolist() == list(range(q - k + 1, q + 1))


@pytest.mark.parametrize("k", KS)
def test_emulated_window_on_the_last_base(emulated, k):
    """Blocks of T = k .. k + 32 valid bases whose words and vwords hold
    exactly ceil(T/16) and ceil(T/32) words (a load past them faults):
    the window that ends on base T - 1 is valid, both kernels equal their
    plain versions, and it is counted."""
    rng = np.random.default_rng(500 + k)
    for T in range(k, k + 33):
        words, vwords, T = _exact_block(_codes(rng, T))
        got = _emulated_keys(emulated, words, vwords, T, k)
        assert torch.equal(got, dc.extract_plain(words, vwords, T, k))
        assert got[T - k] != dc.SENTINEL and (got[T - k + 1:] == dc.SENTINEL).all()
        table = dc.make_table(torch.unique(got[:T - k + 1]), k)
        got_counts, want_counts = _both_counts(emulated, words, vwords, T, k, table)
        assert torch.equal(got_counts, want_counts)
        assert got_counts[torch.searchsorted(table.keys, got[T - k])] >= 1


@pytest.mark.parametrize("k", [16, 31])
def test_emulated_first_and_last_window_of_a_cta(emulated, k):
    """The first and last window of each 256-thread block of a valid
    block: valid, the plain version's keys, counted."""
    rng = np.random.default_rng(600 + k)
    words, vwords, T = _exact_block(_codes(rng, 3 * 256 + k + 40))
    got = _emulated_keys(emulated, words, vwords, T, k)
    assert torch.equal(got, dc.extract_plain(words, vwords, T, k))
    edges = torch.tensor([0, 255, 256, 511, 512, 767])
    assert (got[edges] != dc.SENTINEL).all()
    table = dc.make_table(torch.unique(got[edges]), k)
    got_counts, want_counts = _both_counts(emulated, words, vwords, T, k, table)
    assert torch.equal(got_counts, want_counts) and (got_counts >= 1).all()


@pytest.mark.parametrize("k", KS)
def test_emulated_count_at_each_directory_size(emulated, k):
    """One block and table counted with the directory at d = 16 (at most
    2k), at the rule's d, and at 0 (one bucket): the plain version's
    counts every time."""
    seqs = _reads(700 + k, 120, short=10)
    words, vwords, n_bases = _block(seqs)
    keys = dc.extract_plain(words, vwords, n_bases, k)
    table_keys = torch.unique(keys[keys != dc.SENTINEL])[::2].contiguous()
    rule = dc.directory_bits(len(table_keys), k)
    for d in sorted({min(16, 2 * k), rule, 0}):
        table = dc.make_table(table_keys, k, d)
        assert table.bits == d and len(table.directory) == (1 << d) + 1
        got, want = _both_counts(emulated, words, vwords, n_bases, k, table)
        assert torch.equal(got, want) and got.sum() > 0


def _kmer(codes) -> int:
    """The forward encoding of a k-mer's codes, first base highest."""
    key = 0
    for c in codes:
        key = key << 2 | int(c)
    return key


@pytest.mark.parametrize("d", ["16", "rule"])
def test_emulated_count_with_every_key_in_one_bucket(emulated, d):
    """Hundreds of canonical 16-mers that share their first 8 bases, so
    one bucket at d = 16 (and at the rule's d) holds the whole table:
    D1-count narrows it by binary steps before its scan, and counts each
    key once for each read that holds it."""
    k = 16
    rng = np.random.default_rng(17)
    prefix = np.array([0, 1, 2, 3, 0, 1, 2, 0])
    kmers = {}
    for tail in _codes(rng, (1500, 8)):
        codes = np.concatenate([prefix, tail])
        fw, rc = _kmer(codes), _kmer(3 - codes[::-1])
        if fw <= rc:
            kmers[fw] = codes
    keys = np.array(sorted(kmers), dtype=np.int64)
    table = dc.make_table(torch.from_numpy(keys), k, 16 if d == "16" else None)
    widths = torch.diff(table.directory.long())
    assert (widths > 0).sum() == 1 and widths.max() == len(keys) > 50 * dc.SCAN
    seqs = [bytes(b"ACGT"[c] for c in kmers[key]) for key in keys[::3]] * 2 + _reads(18, 60)
    words, vwords, n_bases = _block(seqs)
    got, want = _both_counts(emulated, words, vwords, n_bases, k, table)
    assert torch.equal(got, want)
    assert (got[::3] >= 2).all() and got.sum() >= 2 * len(keys[::3])


@pytest.mark.parametrize("n", [0, 1, 2, 3])
def test_emulated_count_into_tiny_tables(emulated, n):
    """Tables of 0-3 keys whose next int64 in memory is a key the reads
    hold (above them, so the table is still sorted), with counts whose
    next int32 is watched: a pair read past the table's end would count
    that key into counts[n]."""
    k = 31
    seqs = _reads(800 + n, 60)
    words, vwords, n_bases = _block(seqs)
    keys = dc.extract_plain(words, vwords, n_bases, k)
    present = torch.unique(keys[keys != dc.SENTINEL])
    held = torch.cat([present[:n], present[-1:]]).clone()
    assert held.data_ptr() % 16 == 0
    counts = torch.zeros(n + 1, dtype=torch.int32)
    table = dc.make_table(held[:n], k)
    assert table.bits == dc.directory_bits(n, k) <= 1
    assert n == 0 or table.keys.data_ptr() == held.data_ptr()
    dc.count(words, vwords, n_bases, k, table, counts[:n], kernel=emulated["count"],
             stream=STREAM)
    want = torch.zeros(n, dtype=torch.int32)
    dc.count_plain(words, vwords, n_bases, k, table, want)
    assert torch.equal(counts[:n], want) and counts[n] == 0
    assert want.sum() >= n


# -- D1-count-keys: keys already extracted, D1-count's search ----------------


def _both_key_counts(emulated, keys, k, table):
    got = torch.zeros(table.keys.shape, dtype=torch.int32)
    dc.count_keys(keys, k, table, got, kernel=emulated["count_keys"], stream=STREAM)
    want = torch.zeros_like(got)
    dc.count_keys_plain(keys, table, want)
    return got, want


def _routed_keys(seed, k, n=150):
    """A block's keys as a rank receives them: the valid windows of
    reads, with SENTINEL keys (a block's invalid windows) left in."""
    words, vwords, n_bases = _block(_reads(seed, n, short=10))
    return dc.extract_plain(words, vwords, n_bases, k)


@pytest.mark.parametrize("k", [1, 31])
@pytest.mark.parametrize("d", ["0", "16", "rule"])
def test_emulated_count_keys_matches_plain(emulated, k, d):
    """Keys of reads (SENTINEL among them), into a table of every other
    read key and keys no read has, with the directory at d = 0, 16 (at
    most 2k) and the rule's d: the plain version's counts, and the host
    engine's for the keys the table holds."""
    keys = _routed_keys(900 + k, k)
    assert (keys == dc.SENTINEL).any()
    valid = keys[keys != dc.SENTINEL]
    rng = np.random.default_rng(k)
    absent = torch.from_numpy(rng.integers(0, 4 ** k, 40, dtype=np.int64))
    table_keys = torch.unique(torch.cat([torch.unique(valid)[::2], absent]))
    bits = {"0": 0, "16": min(16, 2 * k), "rule": None}[d]
    table = dc.make_table(table_keys, k, bits)
    got, want = _both_key_counts(emulated, keys, k, table)
    assert torch.equal(got, want) and got.sum() > 0
    uniq, cnt = torch.unique(valid, return_counts=True)
    held = torch.isin(uniq, table_keys)
    expected = torch.zeros(len(table_keys), dtype=torch.int32)
    expected[torch.searchsorted(table_keys, uniq[held])] = cnt[held].to(torch.int32)
    assert torch.equal(got, expected)


def test_emulated_count_keys_of_absent_and_foreign_keys(emulated):
    """Keys no table holds, SENTINEL alone, and keys wider than 2k bits
    (which a directory of k-mers cannot bucket): nothing is counted."""
    k = 15
    table = dc.make_table(torch.unique(torch.randint(0, 4 ** k, (300,),
                                                      generator=torch.Generator().manual_seed(3))), k)
    absent = torch.tensor([x for x in range(0, 4 ** k, 4 ** k // 97)
                           if x not in set(table.keys.tolist())], dtype=torch.int64)
    wide = torch.tensor([4 ** k, 4 ** k + 5, (1 << 62) + 1, -1, -(1 << 40)], dtype=torch.int64)
    sentinel = torch.full((64,), dc.SENTINEL, dtype=torch.int64)
    for keys in (absent, wide, sentinel, torch.cat([sentinel, absent, wide])):
        got, want = _both_key_counts(emulated, keys.contiguous(), k, table)
        assert torch.equal(got, want) and got.sum() == 0


def test_emulated_count_keys_into_an_empty_partition(emulated):
    """A rank whose partition holds no key (and keys routed to it
    anyway): nothing is found and nothing is written."""
    table = dc.make_table(torch.zeros(0, dtype=torch.int64), 31)
    got, want = _both_key_counts(emulated, _routed_keys(5, 31), 31, table)
    assert got.shape == (0,) and want.shape == (0,)


@pytest.mark.parametrize("k", [1, 16, 31])
def test_emulated_count_keys_in_the_last_directory_bucket(emulated, k):
    """The largest k-mer (all ones: the last bucket at d = 16 and at the
    rule's d) and the key 0 (the first bucket) among the keys, each
    counted as often as it comes."""
    top, table_keys = 4 ** k - 1, torch.tensor([0, 4 ** k // 3, 4 ** k - 1], dtype=torch.int64)
    keys = torch.tensor([top, 0, top, 5 % 4 ** k, top, dc.SENTINEL, 0], dtype=torch.int64)
    for d in sorted({min(16, 2 * k), dc.directory_bits(len(table_keys), k)}):
        table = dc.make_table(table_keys, k, d)
        assert (table.keys[-1] >> table.shift).item() == (1 << d) - 1
        got, want = _both_key_counts(emulated, keys, k, table)
        assert torch.equal(got, want)
        assert got.tolist()[0] == 2 and got.tolist()[-1] == 3


def test_emulated_count_keys_is_count_on_the_same_windows(emulated):
    """D1-count on a block and D1-count-keys on that block's keys give
    the same counts: the two kernels share one search."""
    k = 31
    seqs = _reads(44, 200, short=20)
    words, vwords, n_bases = _block(seqs)
    keys = dc.extract_plain(words, vwords, n_bases, k)
    table = dc.make_table(torch.unique(keys[keys != dc.SENTINEL])[1::3].contiguous(), k)
    from_block, _ = _both_counts(emulated, words, vwords, n_bases, k, table)
    from_keys, _ = _both_key_counts(emulated, keys, k, table)
    assert torch.equal(from_block, from_keys) and from_keys.sum() > 0


# -- D1-route: a block's keys binned by (owner, region), stably ---------------


def _both_routes(emulated, keys, k, n_ranks, r):
    got = dc.route(keys, k, n_ranks, r, kernel=emulated["route"], stream=STREAM)
    return got, dc.route_plain(keys, k, n_ranks, r)


def _assert_same_route(got, want, keys, k, n_ranks, r):
    (got_keys, got_sizes), (want_keys, want_sizes) = got, want
    assert torch.equal(got_keys, want_keys)
    assert torch.equal(got_sizes, want_sizes) and got_sizes.shape == (n_ranks, 1 << r)
    valid = (keys >= 0) & (keys < 4 ** k)
    assert int(got_sizes.sum()) == int(valid.sum()) == len(got_keys)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("n_ranks", [1, 2, 4])
def test_emulated_route_matches_plain(emulated, k, n_ranks):
    """A block's keys (SENTINEL among them) binned for 1, 2 and 4 owners
    at r = 0, 1, 4 and 9 region bits (at most 2k): the plain version's
    keys in its order and its sizes; each bin's keys are the block's
    keys of that owner and region in block order."""
    keys = _routed_keys(1200 + k, k, n=40)
    assert (keys == dc.SENTINEL).any()
    for r in sorted({min(x, 2 * k) for x in (0, 1, 4, 9)}):
        got, want = _both_routes(emulated, keys, k, n_ranks, r)
        _assert_same_route(got, want, keys, k, n_ranks, r)
        valid = keys[keys != dc.SENTINEL]
        bins = dc.route_bins(valid, k, n_ranks, r)
        starts = torch.cumsum(got[1].reshape(-1), 0) - got[1].reshape(-1)
        for b in torch.unique(bins)[:5].tolist():
            run = got[0][starts[b]:starts[b] + got[1].reshape(-1)[b]]
            assert torch.equal(run, valid[bins == b])


def test_emulated_route_bins_spanning_ctas(emulated, monkeypatch):
    """One bin of every key (r = 0, one owner) and a few bins of repeated
    keys over CTAs of several tiles each (ROUTE_MAX_CTAS lowered), with
    a tail tile: the keys keep their order across tiles and CTAs."""
    rng = np.random.default_rng(7)
    k = 15
    few = torch.from_numpy(rng.integers(0, 4 ** k, 6, dtype=np.int64))
    keys = few[torch.from_numpy(rng.integers(0, 6, 5 * dc.ROUTE_TILE + 77))].contiguous()
    mixed = torch.from_numpy(rng.integers(0, 4 ** k, 3 * dc.ROUTE_TILE + 5, dtype=np.int64))
    mixed[::7] = dc.SENTINEL
    for max_ctas in (1, 2, 64):
        monkeypatch.setattr(dc, "ROUTE_MAX_CTAS", max_ctas)
        for block, n_ranks, r in ((keys, 1, 0), (keys, 3, 2), (mixed, 2, 6), (mixed, 4, 12)):
            got, want = _both_routes(emulated, block, k, n_ranks, r)
            _assert_same_route(got, want, block, k, n_ranks, r)


def test_emulated_route_of_empty_and_invalid_blocks(emulated):
    """An empty block, a block of SENTINEL keys and one of keys outside
    2k bits: no key out, every size 0; a block of one valid key among
    them: that key alone."""
    k = 11
    sentinel = torch.full((700,), dc.SENTINEL, dtype=torch.int64)
    wide = torch.tensor([4 ** k, -1, -(1 << 40), (1 << 62) + 3] * 50, dtype=torch.int64)
    for block in (torch.zeros(0, dtype=torch.int64), sentinel, wide):
        got, want = _both_routes(emulated, block, k, 4, 3)
        _assert_same_route(got, want, block, k, 4, 3)
        assert len(got[0]) == 0 and int(got[1].sum()) == 0
    one = torch.cat([sentinel[:300], torch.tensor([12345], dtype=torch.int64), wide]).contiguous()
    got, want = _both_routes(emulated, one, k, 2, 5)
    _assert_same_route(got, want, one, k, 2, 5)
    assert got[0].tolist() == [12345]


def test_emulated_route_refuses_what_it_does_not_take(emulated):
    """More bins than one CTA's shared memory holds, r past 2k, and the
    raw entry point's own checks."""
    keys = _routed_keys(3, 31, n=20)
    with pytest.raises(ValueError, match="bins"):
        dc.route(keys, 31, 4, 13, kernel=emulated["route"], stream=STREAM)
    with pytest.raises(ValueError, match="bins"):
        dc.route(keys, 2, 1, 5, kernel=emulated["route"], stream=STREAM)
    out = torch.empty_like(keys)
    sizes = torch.empty(1 << 15, dtype=torch.int64)
    starts = torch.empty(1 << 15, dtype=torch.int64)
    hist = torch.empty(1 << 15, dtype=torch.int32)
    raw = emulated["route"].raw
    assert raw(keys.data_ptr(), len(keys), 31, 2, 14, 1, out.data_ptr(), sizes.data_ptr(),
               hist.data_ptr(), starts.data_ptr(), STREAM) != 0
    assert raw(keys.data_ptr(), len(keys), 31, 1, 0, 0, out.data_ptr(), sizes.data_ptr(),
               hist.data_ptr(), starts.data_ptr(), STREAM) != 0


# -- D1-count-keys on runs in region order, as ranks receive them -------------


def _received(keys, k, n_ranks, r, senders, owner):
    """The keys ``owner`` receives when ``senders`` ranks each route a
    slice of ``keys``: (received keys, runs [senders, 2^r])."""
    runs, parts = [], []
    for chunk in torch.tensor_split(keys, senders):
        binned, sizes = dc.route_plain(chunk.contiguous(), k, n_ranks, r)
        flat = sizes.reshape(-1)
        start = int(flat[:owner << r].sum())
        parts.append(binned[start:start + int(sizes[owner].sum())])
        runs.append(sizes[owner])
    return torch.cat(parts).contiguous(), torch.stack(runs)


def _partition(keys, k, n_ranks, owner, absent=40, seed=0):
    """The owner's partition of every other distinct valid key of
    ``keys`` and of keys no read has."""
    valid = keys[(keys >= 0) & (keys < 4 ** k)]
    rng = np.random.default_rng(seed)
    extra = torch.from_numpy(rng.integers(0, 4 ** k, absent, dtype=np.int64))
    table = torch.unique(torch.cat([torch.unique(valid)[::2], extra]))
    return table[dc.owner_of(table, n_ranks) == owner].contiguous()


@pytest.mark.parametrize("k", [5, 17, 31])
@pytest.mark.parametrize("n_ranks, r, senders", [(1, 0, 1), (2, 3, 2), (4, 6, 3), (3, 9, 4)])
def test_emulated_count_keys_in_region_order(emulated, emulated_kpt, k, n_ranks, r, senders):
    """Keys as an owner receives them from several senders (each run in
    region order, runs [senders, 2^r], read region-major; runs' tails
    inside a tile, empty regions), into its partition with keys no read
    has, with the directory at the rule's d, at d = 16 and at d = 2
    (fewer bits than the regions): the plain version's counts, the
    host's counts of the same keys, and the counts of the same keys read
    in one segment; with D1_KPT = 1, 3 and 8."""
    r = min(r, 2 * k)
    keys = _routed_keys(2000 + k, k, n=70)
    for lib in (emulated, emulated_kpt):
        for owner in range(n_ranks):
            received, runs = _received(keys, k, n_ranks, r, senders, owner)
            part = _partition(keys, k, n_ranks, owner, seed=k)
            for d in sorted({None, min(16, 2 * k), min(2, 2 * k)}, key=str):
                table = dc.make_table(part, k, d)
                got = torch.zeros(len(part), dtype=torch.int32)
                dc.count_keys(received, k, table, got, runs, kernel=lib["count_keys"],
                              stream=STREAM)
                want = torch.zeros_like(got)
                dc.count_keys_plain(received, table, want)
                assert torch.equal(got, want)
                flat = torch.zeros_like(got)
                dc.count_keys(received, k, table, flat, kernel=lib["count_keys"], stream=STREAM)
                assert torch.equal(flat, want)
                uniq, cnt = torch.unique(received, return_counts=True)
                held = torch.isin(uniq, part)
                expected = torch.zeros(len(part), dtype=torch.int32)
                expected[torch.searchsorted(part, uniq[held])] = cnt[held].to(torch.int32)
                assert torch.equal(got, expected)
                assert len(part) == 0 or got.sum() > 0 or not held.any()


def test_emulated_count_keys_out_of_region_order(emulated, emulated_kpt):
    """Keys shuffled out of region order while the runs still claim
    regions, and keys absent from the partition: still the plain
    version's counts (order sets only the speed)."""
    k = 21
    keys = _routed_keys(77, k, n=60)
    received, runs = _received(keys, k, 2, 5, 2, 1)
    shuffled = received[torch.from_numpy(np.random.default_rng(1).permutation(len(received)))]
    part = _partition(keys, k, 2, 1, absent=200)
    table = dc.make_table(part, k)
    want = torch.zeros(len(part), dtype=torch.int32)
    dc.count_keys_plain(shuffled, table, want)
    for lib in (emulated, emulated_kpt):
        got = torch.zeros_like(want)
        dc.count_keys(shuffled.contiguous(), k, table, got, runs, kernel=lib["count_keys"],
                      stream=STREAM)
        assert torch.equal(got, want) and want.sum() > 0


def test_count_keys_segments_are_region_major():
    """segments(): region-major order over the senders' runs, each
    segment's keys where its sender's run holds them."""
    runs = torch.tensor([[2, 0, 3, 1], [1, 4, 0, 2]], dtype=torch.int64)
    seg_v, seg_p = dc.segments(13, runs, CPU)
    # (region, sender): (0,0) 2 (0,1) 1 (1,0) 0 (1,1) 4 (2,0) 3 (2,1) 0 (3,0) 1 (3,1) 2
    assert seg_v.tolist() == [0, 2, 3, 3, 7, 10, 10, 11, 13]
    assert seg_p.tolist() == [0, 6, 2, 7, 2, 11, 5, 11]
    for keys in (torch.zeros(12, dtype=torch.int64), torch.zeros(13, dtype=torch.int64)):
        with pytest.raises(ValueError, match="runs"):
            dc.count_keys(keys, 31, dc.make_table(torch.zeros(0, dtype=torch.int64), 31),
                          torch.zeros(0, dtype=torch.int32),
                          runs if len(keys) == 12 else runs.reshape(-1))
