"""Kernel S1 of ``pangenie_tpu_torch/csrc/sampling_dp.cu`` (the sweep and
the segmented chase) run on the CPU by an emulator of the CUDA threads,
against its plain version, bit for bit.

The kernel source is compiled with g++ against the headers of
``tests/cuda_emulator/`` (``__reduce_min_sync`` and the shuffles are lane
barriers between fibers, the dynamic shared memory one array), and the
one textual substitution makes a launch run every thread of every block
as a fiber. The wrappers ``sampling.s1_sweep`` / ``s1_chase`` allocate
and lay out the backtraces as on the card. So the kernels' own
reductions, tie rules, register ring, packed stores, partials and chase
run as written, one block at a time; their timing is not modelled.
``tests/test_torch_cuda_kernels.py`` holds the real kernels against the
plain version on the card.
"""

import ctypes
import os
import re
import subprocess

import numpy as np
import pytest
import torch

from pangenie_tpu_torch import _build
from pangenie_tpu_torch.hmm import sampling

HERE = os.path.dirname(os.path.abspath(__file__))
UMAX = sampling.UINT_MAX


def _emulated_source(src: str) -> str:
    src, n = re.subn(
        r"kernel<<<blocks, threads, smem, \(cudaStream_t\)stream>>>\(args\.\.\.\);",
        "if (emu_run(blocks, threads, smem, [&]() { kernel(args...); }))"
        " return (int)cudaErrorInvalidValue;", src)
    assert n == 1, "the launch in csrc/sampling_dp.cu changed"
    return src


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """csrc/sampling_dp.cu built against the emulator, its entry points bound."""
    out = tmp_path_factory.mktemp("s1_emulated")
    src = out / "s1_emulated.cpp"
    with open(os.path.join(_build.CUDA_SRC_DIR, "sampling_dp.cu")) as f:
        src.write_text(_emulated_source(f.read()))
    lib = out / "libs1_emulated.so"
    subprocess.run(
        ["g++", "-std=c++17", "-O1", "-shared", "-fPIC", "-Wno-unknown-pragmas",
         "-I", os.path.join(HERE, "cuda_emulator"), "-o", str(lib),
         os.path.join(HERE, "cuda_emulator", "emu.cpp"), str(src)],
        check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib))
    lib.pg_s1_sweep.argtypes = sampling.S1._argtypes
    lib.pg_s1_chase.argtypes = sampling.S1_CHASE._argtypes
    return lib


def _checked(fn):
    def call(*args):
        code = fn(*args)
        assert code == 0, f"emulated launch returned {code}"
    return call


def _emulated_iteration(lib, cost, mask, switch):
    bt, best, ends = sampling.s1_sweep(cost, mask, switch, _checked(lib.pg_s1_sweep))
    paths = sampling.s1_chase(bt, ends, cost.shape[2], _checked(lib.pg_s1_chase))
    assert torch.equal(sampling.chase_plain(bt, ends), paths)
    return paths, best.to(torch.int64) & UMAX


def _inputs(seed, C, N, P, masked=0.3, max_cost=3):
    """Costs 0..max_cost (ties everywhere), a share of paths masked,
    switch costs 0..5; with C > 1 the last chromosome has an all-masked
    column near its end (every score after it is UMAX)."""
    rng = np.random.default_rng(seed)
    cost = rng.integers(0, max_cost + 1, (C, N, P)).astype(np.uint32)
    mask = rng.random((C, N, P)) >= masked
    if C > 1 and N > 6:
        mask[C - 1, N - 3] = False
    switch = rng.integers(0, 6, (C, N)).astype(np.uint32)
    return (torch.from_numpy(cost.view(np.int32)), torch.from_numpy(mask),
            torch.from_numpy(switch.view(np.int32)))


def _assert_matches_plain(lib, cost, mask, switch):
    got = _emulated_iteration(lib, cost, mask, switch)
    want = sampling.viterbi_iteration_plain(cost, mask, switch)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    return want


# N = 37 columns: chase segments of 7, the last one short
@pytest.mark.parametrize("P", [1, 31, 32, 33, 123, 128, 129, 300])
def test_emulated_s1_matches_plain(emulated, P):
    """Every sweep layout (one warp of 1-4 paths a lane, 2 and 3 warps
    with uint8 and uint16 backtraces), C=2, ties, masked paths and
    all-masked columns."""
    N = 37
    assert N % sampling.chase_segment(N) != 0
    _paths, best = _assert_matches_plain(
        emulated, *_inputs(P, 2, N, P, masked=0.3 if P > 1 else 0.0))
    assert int(best[0]) < UMAX and int(best[1]) == UMAX


@pytest.mark.parametrize("P", [200, 300])
def test_emulated_s1_minimum_in_a_later_warp(emulated, P):
    """The multi-warp merge where the cheapest paths sit in the last warp
    (costs 0..1 there, 2..3 elsewhere) and switches often cost 0, so
    first and second minima tie across warps."""
    rng = np.random.default_rng(P)
    C, N = 2, 40
    cost = rng.integers(2, 4, (C, N, P)).astype(np.uint32)
    cost[:, :, P - 40:] = rng.integers(0, 2, (C, N, 40))
    cost[1, ::3, 7] = 0
    mask = rng.random((C, N, P)) >= 0.2
    switch = rng.integers(0, 2, (C, N)).astype(np.uint32)
    _assert_matches_plain(emulated, torch.from_numpy(cost.view(np.int32)),
                          torch.from_numpy(mask), torch.from_numpy(switch.view(np.int32)))


@pytest.mark.parametrize("P", [100, 300])
def test_emulated_s1_all_scores_tied(emulated, P):
    """Costs all 0 and half the switches free: every column's first and
    second minima tie, in one lane, and the first path switches to the
    second wherever the switch is free."""
    rng = np.random.default_rng(P)
    C, N = 2, 30
    cost = np.zeros((C, N, P), dtype=np.int32)
    mask = rng.random((C, N, P)) >= 0.1
    switch = rng.integers(0, 2, (C, N)).astype(np.int32)
    _assert_matches_plain(emulated, torch.from_numpy(cost), torch.from_numpy(mask),
                          torch.from_numpy(switch))


@pytest.mark.parametrize("P", [160, 400])
def test_emulated_s1_second_minimum_in_another_warp(emulated, P):
    """Two free paths, one in the first warp and one in a later warp,
    the rest costing 3: the first minimum's second lies in another warp,
    and the path alternates between the two at free switches."""
    rng = np.random.default_rng(P)
    C, N = 1, 30
    cost = np.full((C, N, P), 3, dtype=np.int32)
    cost[:, :, [5, P - 3]] = 0
    mask = np.ones((C, N, P), dtype=bool)
    switch = rng.integers(0, 2, (C, N)).astype(np.int32)
    paths, _best = _assert_matches_plain(emulated, torch.from_numpy(cost),
                                         torch.from_numpy(mask), torch.from_numpy(switch))
    assert set(paths[0].tolist()) == {5, P - 3}


@pytest.mark.parametrize("P", [5, 123, 300])
def test_emulated_s1_single_column(emulated, P):
    _assert_matches_plain(emulated, *_inputs(P + 1, 3, 1, P))


@pytest.mark.parametrize("C,N,P", [(1, 64, 7), (2, 50, 65), (1, 17, 200)])
def test_emulated_s1_mostly_masked(emulated, C, N, P):
    """95% of the paths masked: dead columns whose scores saturate, and
    a last column with nothing alive (best UMAX) in chromosome 0."""
    cost, mask, switch = _inputs(N, C, N, P, masked=0.95)
    mask[0, -1] = False
    got = _emulated_iteration(emulated, cost, mask, switch)
    want = sampling.viterbi_iteration_plain(cost, mask, switch)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int(want[1][0]) == UMAX


@pytest.mark.parametrize("P", [3, 40])
def test_emulated_s1_saturates(emulated, P):
    """Costs and switches near 2^32 saturate at UMAX as uint32 adds do."""
    C, N = 2, 9
    cost = np.full((C, N, P), 0xF0000000, dtype=np.uint32)
    cost[:, :, 1] = 0x7FFFFFFF
    cost[1, ::2, 2] = 1
    mask = np.ones((C, N, P), dtype=bool)
    switch = np.full((C, N), 0xFFFFFFF0, dtype=np.uint32)
    _assert_matches_plain(emulated, torch.from_numpy(cost.view(np.int32)),
                          torch.from_numpy(mask), torch.from_numpy(switch.view(np.int32)))


def test_emulated_s1_long_enough_for_the_ring_and_segments(emulated):
    """More columns than several register rings and chase segments of
    15, C=3 (padding-like neutral tail on one chromosome)."""
    cost, mask, switch = _inputs(9, 3, 211, 45, masked=0.5)
    cost[2, 150:] = 0
    mask[2, 150:] = True
    switch[2, 150:] = 1
    _assert_matches_plain(emulated, cost, mask, switch)


def test_emulated_s1_rejects_another_layout(emulated):
    """The sweep and the chase refuse a backtrace row other than
    sweep_layout's, and path counts past MAX_PATHS."""
    cost, mask, switch = _inputs(0, 1, 4, 33)
    _w, _r, row = sampling.sweep_layout(33)
    bt = torch.empty((1, 4, row + 32), dtype=torch.uint8)
    out = torch.empty((1,), dtype=torch.int32)
    args = (cost.data_ptr(), mask.data_ptr(), switch.data_ptr(), bt.data_ptr(),
            out.data_ptr(), out.data_ptr(), 1, 4)
    assert emulated.pg_s1_sweep(*args, 33, row + 32, None) != 0
    assert emulated.pg_s1_sweep(*args, sampling.MAX_PATHS + 1, row, None) != 0
    maps = torch.empty((1, 2, 33), dtype=torch.int32)
    paths = torch.empty((1, 4), dtype=torch.int32)
    assert emulated.pg_s1_chase(bt.data_ptr(), out.data_ptr(), maps.data_ptr(),
                                paths.data_ptr(), 1, 4, 33, row + 32, 2, None) != 0
