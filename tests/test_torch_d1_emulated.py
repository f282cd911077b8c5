"""Kernels D1-extract and D1-count of ``pangenie_tpu_torch/csrc/kmer_count.cu``
run on the CPU by an emulator of the CUDA threads, through the real
wrappers (``device_counter.extract`` and ``count``), against their plain
versions on the same packed blocks: the keys and the counts must be
equal.

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


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """csrc/kmer_count.cu built against the emulator and loaded: its two
    entry points bound and checked (a call that returns a CUDA error
    fails the test)."""
    with open(os.path.join(_build.CUDA_SRC_DIR, "kmer_count.cu")) as f:
        text, n = re.subn(
            r"kernel<<<\(unsigned\)blocks, D1_THREADS, 0, \(cudaStream_t\)stream>>>\(args\.\.\.\);",
            "if (emu_run((int)blocks, D1_THREADS, 0, [&]() { kernel(args...); }))"
            " return (int)cudaErrorInvalidValue;", f.read())
    assert n == 1, "the launch in csrc/kmer_count.cu changed"
    out = tmp_path_factory.mktemp("d1_emulated")
    (out / "kmer_count.cpp").write_text(text + INTRINSICS)
    lib_path = out / "libkmer_count.so"
    subprocess.run(
        ["g++", "-std=c++17", "-O1", "-shared", "-fPIC", "-I",
         os.path.join(HERE, "cuda_emulator"), "-o", str(lib_path),
         os.path.join(HERE, "cuda_emulator", "emu.cpp"), str(out / "kmer_count.cpp")],
        check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    bound = {}
    for name, kernel in (("extract", dc.D1_EXTRACT), ("count", dc.D1_COUNT)):
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
                            ("pg_d1_scan", [], ctypes.c_int)):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, res
        bound[name] = fn
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
