"""Kernels D1-extract and D1-count of ``pangenie_tpu_torch/csrc/kmer_count.cu``
run on the CPU by an emulator of the CUDA threads, through the real
wrappers (``device_counter.extract`` and ``count``), against their plain
versions on the same packed blocks: the keys and the counts must be
equal.

The kernel source is compiled with g++ against the headers of
``tests/cuda_emulator/`` (each thread a fiber, blocks one after another;
an ``atomicAdd`` is a plain add, since fibers are cooperative), and the
one textual substitution makes the launch run every thread of every
block. So the kernels' indexing, bit extraction, directory search and
bounds run as written; their timing is not modelled.
``tests/test_torch_cuda_kernels.py`` holds the real kernels against the
plain versions on the card.
"""

import ctypes
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
    (out / "kmer_count.cpp").write_text(text)
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
    """A key whose top 16 bits are all ones (the last directory bucket:
    eight T's first, T...TA...A, whose reverse complement starts with as
    many) and the key 0 (the first), counted from reads that hold them."""
    half = k // 2
    last = b"T" * (k - half) + b"A" * half
    seqs = [last, b"C" + last + b"G", b"A" * k, last + b"N" + last]
    words, vwords, n_bases = _block(seqs)
    keys = np.unique(ExactKmerCounter._extract_canonical(seqs, k))
    table = dc.make_table(torch.from_numpy(keys.view(np.int64)), k)
    d = min(dc.DIR_BITS, 2 * k)
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
