"""Kernel V1 of ``pangenie_tpu_torch/csrc/viterbi.cu`` (the phasing Viterbi:
a CTA of W warps a chain, the top-2 statistics as merge trees, the sweep
with backtraces and the chase in one launch) run on the CPU by an
emulator of the CUDA threads, against its plain version
(``viterbi.segment_plain``) on the same float32 inputs: the chased
states, the state before the first column, the backtraces and the exit
carry's bits must be equal.

The kernel source is compiled with g++ against the headers of
``tests/cuda_emulator/`` (a cp.async is a plain copy, the shuffles,
``__syncwarp`` and ``__syncthreads`` are barriers between fibers, a warp
runs until all its threads wait before the next one starts, the dynamic
shared memory one array a block filled with NaN bits), and the one
textual substitution makes a launch run every thread of every block as a
fiber. Besides the source as it is (W by its rule on Q), builds with
``-DV1_WARPS=w`` run every Q on w = 1, 2, 4, 8 and 16 warps, and a mutant
whose merge keeps the FIRST index on ties must fail. The wrapper
``v1_kernels.launch`` allocates the outputs and lays out the backtraces
as on the card. So the kernel's own layout, ring, state copy, merge
trees, reductions, barriers and chunked chase run as written; their
timing is not modelled. ``tests/test_torch_cuda_kernels.py`` holds the
real kernel against the plain version on the card.
"""

import ctypes
import os
import re
import subprocess

import numpy as np
import pytest
import torch

from pangenie_tpu_torch import _build
from pangenie_tpu_torch.hmm import v1_kernels, viterbi
from test_torch_cuda_kernels import _v1_inputs

HERE = os.path.dirname(os.path.abspath(__file__))
torch.set_num_threads(1)
# the tie rule of the order (value, index) that the merges and the
# classes' combination share, and the mutant that keeps the first index
TIE_RULE = "return v > w || (v == w && i > j);"
FIRST_INDEX = "return v > w || (v == w && i < j);"


def _emulated_source(src: str) -> str:
    src, n = re.subn(
        r"kernel<<<B, threads, smem, \(cudaStream_t\)stream>>>\(args\.\.\.\);",
        "if (emu_run(B, threads, smem, [&]() { kernel(args...); }))"
        " return (int)cudaErrorInvalidValue;", src)
    assert n == 1, "the launch in csrc/viterbi.cu changed"
    return src


def _build_emulated(out, name, defines=(), substitute=None):
    """csrc/viterbi.cu built against the emulator (with ``-D`` defines,
    and ``substitute`` = (text, replacement) applied once), loaded; its
    entry point bound and checked: a call that returns a CUDA error fails
    the test."""
    with open(os.path.join(_build.CUDA_SRC_DIR, "viterbi.cu")) as f:
        text = _emulated_source(f.read())
    if substitute is not None:
        assert text.count(substitute[0]) == 1, f"{substitute[0]!r} is not in the source once"
        text = text.replace(*substitute)
    src = out / f"{name}.cpp"
    src.write_text(text)
    lib_path = out / f"lib{name}.so"
    subprocess.run(
        ["g++", "-std=c++17", "-O1", "-shared", "-fPIC", "-Wno-unknown-pragmas",
         *(f"-D{d}" for d in defines), "-I", os.path.join(HERE, "cuda_emulator"),
         "-o", str(lib_path), os.path.join(HERE, "cuda_emulator", "emu.cpp"), str(src)],
        check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.pg_v1_viterbi
    fn.argtypes = v1_kernels.V1._argtypes
    fn.restype = ctypes.c_int

    def call(*args):
        code = fn(*args)
        assert code == 0, f"emulated launch returned {code}"
    call.raw = fn
    call.lib = lib
    return call


@pytest.fixture(scope="module")
def builds(tmp_path_factory):
    """A build of the emulated source by name, made once a module:
    "rule" (as it is), "w1" ... "w16" (-DV1_WARPS), "first_index" (the
    mutant)."""
    out = tmp_path_factory.mktemp("v1_emulated")
    made = {}
    kinds = {"rule": {}, "first_index": {"substitute": (TIE_RULE, FIRST_INDEX)},
             **{f"w{w}": {"defines": (f"V1_WARPS={w}",)} for w in (1, 2, 4, 8, 16)}}

    def get(name):
        if name not in made:
            made[name] = _build_emulated(out, name, **kinds[name])
        return made[name]
    return get


@pytest.fixture(scope="module")
def emulated(builds):
    """The source as it is, W by its rule."""
    return builds("rule")


def _start(B, P):
    return (torch.zeros((B, P * P), dtype=torch.float32),
            torch.ones((B,), dtype=torch.int32))


def _emulated_segment(emulated, inputs, carry, first, state_in=None, backtrace=True):
    inputs, carry, first = v1_kernels.checked_inputs(inputs, carry, first)
    return v1_kernels.launch(inputs, carry, first, state_in, backtrace, kernel=emulated)


def _same_bits(a, b):
    return torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def _assert_matches_plain(emulated, inputs, carry, first, state_in=None):
    got = _emulated_segment(emulated, inputs, carry, first, state_in)
    want = viterbi.segment_plain(inputs, carry, first.bool(), state_in)
    assert torch.equal(got.states, want.states)
    assert torch.equal(got.state_out, want.state_out)
    assert torch.equal(got.bt.int(), want.bt)
    assert _same_bits(got.carry, want.carry)
    return got


@pytest.mark.parametrize("A", [1, 2, 8])
@pytest.mark.parametrize("P", [1, 2, 5, 16, 17, 24, 30, 32])
def test_emulated_v1_matches_plain(emulated, P, A):
    """Every lane layout (Q = 1 ... 32), chains of 1 and 3 columns and of
    70 (past the ring of 8 slots and, at P = 32, several chase chunks),
    B = 2 chains, an all-zero column and a duplicated path."""
    for N in (1, 3, 70):
        _assert_matches_plain(emulated, _v1_inputs(100 * P + A + N, 2, N, P, A), *_start(2, P))


@pytest.mark.parametrize("P", [5, 16, 30])
def test_emulated_v1_ties_uniform_and_padding(emulated, P):
    """B = 3 chains: emissions from three values (ties everywhere),
    chains 1 and 2 padded from columns 40 and 9, also with ``uniform``
    transitions (lt = 0)."""
    for uniform in (False, True):
        inputs = _v1_inputs(P, 3, 64, P, 4, ties=True, uniform=uniform, pad_from=(40, 9))
        _assert_matches_plain(emulated, inputs, *_start(3, P))


def test_emulated_v1_repeats_its_bits(emulated):
    """Two launches give the same bits."""
    inputs = _v1_inputs(7, 2, 50, 30, 8)
    a = _emulated_segment(emulated, inputs, *_start(2, 30))
    b = _emulated_segment(emulated, inputs, *_start(2, 30))
    assert _same_bits(a.carry, b.carry) and torch.equal(a.bt, b.bt)
    assert torch.equal(a.states, b.states)


def test_emulated_v1_from_entry_carries_and_given_states(emulated):
    """An entry carry that is not the first column's, and the chase from
    given states (one chain from its last-max argmax: -1)."""
    P, B, N = 17, 2, 30
    inputs = _v1_inputs(11, B, N, P, 8)
    rng = np.random.default_rng(11)
    carry = torch.from_numpy((-rng.random((B, P * P)) * 10).astype(np.float32))
    first = torch.zeros((B,), dtype=torch.int32)
    _assert_matches_plain(emulated, inputs, carry, first, torch.tensor([-1, 200], dtype=torch.int32))


@pytest.mark.parametrize("P", [2, 5, 17])
def test_emulated_v1_minus_inf_rows(emulated, P):
    """Entry rows and columns of -inf but for one value (the last, the
    first), or all -inf, and emissions half -inf; chain 1 all padding
    columns (lt = (0, -inf, -inf)). Where the top-2's second is -inf its
    index is the slice's last, as in the reference, and decides the
    backtraces of states whose every candidate is -inf."""
    inputs, carry = _minus_inf_inputs(P)
    _assert_matches_plain(emulated, inputs, carry, torch.zeros((2,), dtype=torch.int32))


@pytest.mark.parametrize("P,segment", [(30, 7), (16, 25), (3, 1)])
def test_emulated_v1_segmented_equals_full(emulated, monkeypatch, P, segment):
    """The checkpointed form built of emulated launches (forward segments
    without backtraces, then each again with them, chased from the state
    the later one handed back) gives the full run's states."""
    B, N = 2, 61
    inputs = _v1_inputs(P + segment, B, N, P, 4)
    full = viterbi.segment_plain(inputs, *_start(B, P)[:1], torch.ones(B, dtype=torch.bool))
    calls = []

    def emulated_segment(part, carry, first, state_in, backtrace):
        calls.append(backtrace)
        return _emulated_segment(emulated, part, carry, first, state_in, backtrace)

    monkeypatch.setattr(viterbi, "_segment", emulated_segment)
    states = viterbi.checkpointed(inputs, segment)
    assert torch.equal(states, full.states)
    n_segs = -(-N // segment)
    assert calls == [False] * (n_segs - 1) + [True] * n_segs


@pytest.mark.parametrize("P", [1, 2, 5, 16, 17, 24, 30, 32])
@pytest.mark.parametrize("W", [1, 2, 4, 8, 16])
def test_emulated_v1_on_w_warps(builds, W, P):
    """Every Q on W warps a chain (``-DV1_WARPS``: more threads than
    cells at small Q, 32 rows a thread at Q = 32 on one warp, folds of
    up to 32 entries a thread): random columns at N = 3 and 70 with a
    padded chain, and the tied columns of three values."""
    kernel = builds(f"w{W}")
    A = (1, 2, 8)[P % 3]
    for N in (3, 70):
        inputs = _v1_inputs(7 * P + W + N, 2, N, P, A, pad_from=(N // 2,))
        _assert_matches_plain(kernel, inputs, *_start(2, P))
    inputs = _v1_inputs(P + W, 3, 40, P, 4, ties=True, pad_from=(30, 9))
    _assert_matches_plain(kernel, inputs, *_start(3, P))


def _minus_inf_inputs(P):
    """test_emulated_v1_minus_inf_rows's inputs and entry carry."""
    B, N = 2, 12
    inputs = _v1_inputs(50 + P, B, N, P, 4, pad_from=(0,))
    rng = np.random.default_rng(P)
    logea = inputs.logea.numpy().copy()
    logea[:, 2:6][rng.random(logea[:, 2:6].shape) < 0.5] = -np.inf
    inputs = inputs._replace(logea=torch.from_numpy(logea))
    carry = np.full((B, P, P), -np.inf, dtype=np.float32)
    carry[0, :, P - 1] = -rng.random(P)                # every row's last value
    carry[0, 0, :] = -np.inf                           # one row all -inf
    carry[1, P - 1, :] = -rng.random(P)                # every column's last value
    carry[1, :, 0] = -rng.random(P)                    # every row's first value
    sparse = rng.random((P, P)) < 0.3                  # or 70% -inf, through padding
    carry[1] = np.where(sparse, carry[1], -np.inf)
    carry[1, P // 2, P - 1] = -0.5
    return inputs, torch.from_numpy(carry.reshape(B, P * P))


def test_emulated_v1_first_index_mutant_fails(builds):
    """The order's tie rule turned to keep the FIRST index (substituted
    in the source, as the launch is) gives other backtraces or states
    than the plain version on some case: the tied columns and the -inf
    rows catch merge trees that break _top2_last's last-index rule."""
    mutant = builds("first_index")
    failed = 0
    cases = [(_v1_inputs(P, 3, 64, P, 4, ties=True, pad_from=(40, 9)), *_start(3, P))
             for P in (5, 16, 30)]
    cases += [(*_minus_inf_inputs(P), torch.zeros((2,), dtype=torch.int32)) for P in (2, 5, 17)]
    for inputs, carry, first in cases:
        try:
            _assert_matches_plain(mutant, inputs, carry, first)
        except AssertionError:
            failed += 1
    assert failed >= 1


def test_v1_warps_rule_mirrored(emulated):
    """``v1_kernels.warps`` is the source's rule (``pg_v1_warps``) at
    every P V1 takes, and the entry point answers 0 past 32 paths."""
    fn = emulated.lib.pg_v1_warps
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    assert [fn(P) for P in range(1, 33)] == [v1_kernels.warps(P) for P in range(1, 33)]
    assert {v1_kernels.warps(P) for P in range(1, 33)} == {1, 2, 8}
    assert fn(33) == 0 and fn(0) == 0


def test_v1_refuses_33_paths(emulated):
    """Past 32 paths the wrapper raises, naming the limit, and the entry
    point launches nothing."""
    inputs = _v1_inputs(1, 1, 4, 33, 2)
    carry, first = _start(1, 33)
    with pytest.raises(ValueError, match="at most 32 paths"):
        v1_kernels.checked_inputs(inputs, carry, first)
    out = torch.empty_like(carry)
    code = emulated.raw(inputs.logea.data_ptr(), inputs.al.data_ptr(), inputs.lt.data_ptr(),
                        carry.data_ptr(), first.data_ptr(), out.data_ptr(), None, None, None,
                        None, 1, 4, 33, 2, ctypes.c_float(0.0), None)
    assert code != 0
