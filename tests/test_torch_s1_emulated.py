"""Kernel S1 of ``pangenie_tpu_torch/csrc/sampling_dp.cu`` (the sweep, with
its entry and exit rows and without backtraces, and the segmented chase
from given ends) run on the CPU by an emulator of the CUDA threads,
against its plain version, bit for bit.

The kernel source is compiled with g++ against the headers of
``tests/cuda_emulator/`` (``__reduce_min_sync`` and the shuffles are lane
barriers between fibers, the dynamic shared memory one array a block),
and the one textual substitution makes a launch run every thread of
every block as a fiber; the cluster launch (``cudaLaunchKernelEx``) runs
through the emulator's own, the K blocks of a cluster together, with the
cluster barrier, the mbarriers and the pushes into another block's
shared memory of ``cuda_emulator/cluster.cuh``.
The wrappers ``sampling.s1_sweep`` / ``s1_chase`` allocate and lay out
the backtraces as on the card. So the kernels' own reductions, tie
rules, register ring, packed stores, partials, lane and cluster merges,
scratch scores and chase run as written; their timing is not modelled.
Every tier is covered: one warp, up to 8 warps (P <= 1024), a cluster
of CTAs of 2-8 or 9-32 warps (P = 1025-16,385, and the clusters of the
source built with other S1_CLUSTER_RANKS), and 1024 threads of several
paths with their scores in a scratch row and 32-bit backtraces
(P = 65,537).
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
    assert src.count("cudaLaunchKernelEx(") == 1, "the cluster launch changed"
    return src


def _build_emulated(out, defines=()):
    """csrc/sampling_dp.cu built against the emulator into ``out`` (with
    the -D macros ``defines``), its entry points bound."""
    src = out / "s1_emulated.cpp"
    with open(os.path.join(_build.CUDA_SRC_DIR, "sampling_dp.cu")) as f:
        src.write_text(_emulated_source(f.read()))
    lib = out / "libs1_emulated.so"
    subprocess.run(
        ["g++", "-std=c++17", "-O1", "-shared", "-fPIC", "-Wno-unknown-pragmas",
         *(f"-D{d}" for d in defines), "-I", os.path.join(HERE, "cuda_emulator"),
         "-o", str(lib), os.path.join(HERE, "cuda_emulator", "emu.cpp"), str(src)],
        check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib))
    lib.pg_s1_sweep.argtypes = sampling.S1._argtypes
    lib.pg_s1_chase.argtypes = sampling.S1_CHASE._argtypes
    lib.pg_s1_cluster_fits.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    return lib


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    return _build_emulated(tmp_path_factory.mktemp("s1_emulated"))


@pytest.fixture(scope="module")
def emulated_ranks(tmp_path_factory):
    """The emulated library built with S1_CLUSTER_RANKS = k, by k."""
    libs = {}

    def get(k):
        if k not in libs:
            libs[k] = _build_emulated(tmp_path_factory.mktemp(f"s1_emulated_{k}"),
                                      [f"S1_CLUSTER_RANKS={k}"])
        return libs[k]
    return get


def _checked(fn):
    def call(*args):
        code = fn(*args)
        assert code == 0, f"emulated launch returned {code}"
    return call


def _sweep(lib, cost, mask, switch, **kw):
    return sampling.s1_sweep(cost, mask, switch, sweep=_checked(lib.pg_s1_sweep), **kw)


def _chase(lib, bt, ends, P):
    return sampling.s1_chase(bt, ends, P, chase=_checked(lib.pg_s1_chase))


def _emulated_iteration(lib, cost, mask, switch):
    bt, best, ends, _ = _sweep(lib, cost, mask, switch)
    paths, state_out = _chase(lib, bt, ends, cost.shape[2])
    plain_paths, plain_out = sampling.chase_plain(bt, ends)
    assert torch.equal(plain_paths, paths) and torch.equal(plain_out, state_out.long())
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


def _last_warp_paths(P):
    """The paths the sweep's last warp holds: up to 1024 paths the last
    (lanes hold consecutive paths); in a cluster those of the last CTA
    that holds any, in its last warp that holds any (CTAs and their warps
    hold consecutive slices); past that those at 992..1023 modulo 1024."""
    _ranks, warps, per_lane, _row = sampling.sweep_layout(P)
    p = np.arange(P)
    if P <= sampling.CTA_PATHS:
        return p[p // (32 * per_lane) == warps - 1]
    if P <= sampling.CLUSTER_PATHS:
        warp = p // (32 * per_lane)
        return p[warp == warp[-1]]
    return p[p % sampling.THREADS >= sampling.THREADS - 32]


@pytest.mark.parametrize("P", [200, 300, 2048, 4096, 4097, 6405, 8193])
def test_emulated_s1_minimum_in_a_later_warp(emulated, P):
    """The multi-warp merge where the cheapest paths sit in the last warp
    (costs 0..1 there, 2..3 elsewhere) and switches often cost 0, so
    first and second minima tie across warps; in a cluster, the minimum
    and its ties in the last CTA's slice (its last 5 paths at P=6405)."""
    rng = np.random.default_rng(P)
    C, N = 2, 40 if P <= 1024 else 12
    cost = rng.integers(2, 4, (C, N, P)).astype(np.uint32)
    last = _last_warp_paths(P)
    cost[:, :, last] = rng.integers(0, 2, (C, N, len(last)))
    cost[1, ::3, 7] = 0
    mask = rng.random((C, N, P)) >= 0.2
    switch = rng.integers(0, 2, (C, N)).astype(np.uint32)
    _assert_matches_plain(emulated, torch.from_numpy(cost.view(np.int32)),
                          torch.from_numpy(mask), torch.from_numpy(switch.view(np.int32)))


@pytest.mark.parametrize("P", [100, 300, 6405])
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


@pytest.mark.parametrize("P", [160, 400, 4097, 6405])
def test_emulated_s1_second_minimum_in_another_warp(emulated, P):
    """Two free paths, one in the first warp and one in a later warp,
    the rest costing 3: the first minimum's second lies in another warp
    (in a cluster, in another CTA: the first and the last), and the path
    alternates between the two at free switches."""
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
    """The sweep refuses a backtrace row other than sweep_layout's, the
    chase one that does not hold every path."""
    cost, mask, switch = _inputs(0, 1, 4, 33)
    row = sampling.sweep_layout(33)[3]
    bt = torch.empty((1, 4, row + 32), dtype=torch.uint8)
    out = torch.empty((1,), dtype=torch.int32)
    args = (cost.data_ptr(), mask.data_ptr(), switch.data_ptr(), None, None, bt.data_ptr(),
            out.data_ptr(), out.data_ptr(), None, 1, 4)
    assert emulated.pg_s1_sweep(*args, 33, row + 32, None) != 0
    assert emulated.pg_s1_sweep(*args, 33, row, None) == 0
    maps = torch.empty((1, 2, 33), dtype=torch.int32)
    paths = torch.empty((1, 4), dtype=torch.int32)
    chase = (bt.data_ptr(), out.data_ptr(), maps.data_ptr(), paths.data_ptr(), None, 1, 4, 33)
    assert emulated.pg_s1_chase(*chase, 32, 2, None) != 0
    assert emulated.pg_s1_chase(*chase, row + 32, 2, None) == 0


# past 1024 paths a cluster of 5, 8, 8, 7, 8, 8 or 8 CTAs of 2, 2, 4, 5,
# 7 or 9-17 warps (the runtime-W instance), no CTA only padding; N = 11:
# chase segments of 4, the last one short
@pytest.mark.parametrize("P", [1025, 2048, 4096, 4097, 6405, 8193, 16_385])
def test_emulated_s1_wide_matches_plain(emulated, P):
    ranks, warps, _per_lane, _row = sampling.sweep_layout(P)
    assert warps == -(-P // 1024) and ranks == -(-P // (128 * warps))
    assert (ranks - 1) * 128 * warps < P
    _paths, best = _assert_matches_plain(emulated, *_inputs(P, 2, 11, P, masked=0.3))
    assert int(best[0]) < UMAX and int(best[1]) == UMAX


# the source built with other S1_CLUSTER_RANKS (tools/s1_times.py --ranks
# times them): 2 CTAs of 26 warps and 4 of 13 (the runtime-W instance),
# 13 of 4 (past the portable cluster size of 8), at P = 2049 2 of 9 and 4
# of 5, and a cluster of one CTA of 17 warps
@pytest.mark.parametrize("P,ranks", [(6405, 2), (6405, 4), (6405, 16), (2049, 2), (2049, 4),
                                     (2049, 1)])
def test_emulated_s1_cluster_sizes(emulated_ranks, monkeypatch, P, ranks):
    monkeypatch.setattr(sampling, "CLUSTER_RANKS", ranks)
    assert sampling.sweep_layout(P)[:2] == {
        (6405, 2): (2, 26), (6405, 4): (4, 13), (6405, 16): (13, 4), (2049, 2): (2, 9),
        (2049, 4): (4, 5), (2049, 1): (1, 17)}[P, ranks]
    _assert_matches_plain(emulated_ranks(ranks), *_inputs(P + ranks, 2, 9, P, masked=0.3))


def test_emulated_s1_cluster_checks_its_shape(emulated, emulated_ranks, monkeypatch):
    """The cluster's shape is checked before the launch: the rule's
    clusters fit (the emulator's 132 SMs hold 16 clusters of 8 CTAs, 26
    of 5, 8 of 16), a layout of one CTA a chromosome reads 0, and no
    instance takes a CTA of one warp (16 CTAs at P = 1025)."""
    clusters = ctypes.c_int(-1)
    for P, ranks in ((6405, 8), (1025, 5), (40_000, 16)):
        assert sampling.sweep_layout(P)[0] == ranks
        assert emulated.pg_s1_cluster_fits(P, ctypes.byref(clusters)) == 0
        assert clusters.value == 132 // ranks
    assert emulated.pg_s1_cluster_fits(1000, ctypes.byref(clusters)) == 0
    assert clusters.value == 0
    assert emulated_ranks(16).pg_s1_cluster_fits(1025, ctypes.byref(clusters)) != 0
    monkeypatch.setattr(sampling, "CLUSTER_RANKS", 16)
    with pytest.raises(ValueError):
        sampling.sweep_layout(1025)


def test_emulated_s1_scratch_row_matches_plain(emulated):
    """P = 65,537: past what a cluster holds in registers, one CTA of
    1024 threads with the scores in a scratch row; backtraces are
    32-bit."""
    P = 65_537
    assert sampling.sweep_layout(P)[:2] == (1, 32)
    assert sampling.backtrace_dtype(P) == torch.int32
    _assert_matches_plain(emulated, *_inputs(P, 1, 3, P, masked=0.3))


def _carry(seed, C, P):
    """Entry scores as an exit row holds them: uint32 sums, UMAX on masked
    paths, ties at the minimum."""
    rng = np.random.default_rng(seed)
    carry = rng.integers(100, 104, (C, P)).astype(np.uint32)
    carry[rng.random((C, P)) < 0.3] = UMAX
    return torch.from_numpy(carry.view(np.int32))


# every tier: one warp, 3 warps, clusters of 8 CTAs of 2, 7 and 9 warps
@pytest.mark.parametrize("P", [45, 300, 2048, 6405, 8193])
def test_emulated_s1_carries_and_sweep_only(emulated, P):
    """The sweep from an entry row writes the plain sweep's backtraces
    (column 0 an inner column), last column's scores as its exit row,
    best and first minimum; without backtraces the same rows, best and
    ends."""
    C, N = 2, 9
    cost, mask, switch = _inputs(P + 7, C, N, P, masked=0.3)
    carry = _carry(P, C, P)
    got = _sweep(emulated, cost, mask, switch, carry_in=carry, carry_out=True)
    bts, last = sampling.sweep_plain(cost, mask, switch, carry)
    assert torch.equal(got.bt[:, :, :P].to(torch.int64) & 0xFFFF, bts.to(torch.int64))
    assert torch.equal(got.carry_out.to(torch.int64) & UMAX, last)
    best, ends = sampling._first_min(last, torch.arange(P))
    assert torch.equal(got.best.to(torch.int64) & UMAX, best)
    assert torch.equal(got.ends.long(), ends)
    only = _sweep(emulated, cost, mask, switch, carry_in=carry, carry_out=True,
                  backtraces=False)
    assert only.bt is None
    assert torch.equal(only.carry_out, got.carry_out)
    assert torch.equal(only.best, got.best) and torch.equal(only.ends, got.ends)
    # and without an entry row: the exit row of the plain sweep
    plain_out = _sweep(emulated, cost, mask, switch, carry_out=True, backtraces=False)
    assert torch.equal(plain_out.carry_out.to(torch.int64) & UMAX,
                       sampling.sweep_plain(cost, mask, switch)[1])


@pytest.mark.parametrize("P", [33, 300, 2048])
def test_emulated_s1_chase_from_given_ends(emulated, P):
    """The chase from arbitrary states at the last column (not the
    sweep's first minimum) and the state it hands back, as the plain
    chase's."""
    C, N = 3, 23
    cost, mask, switch = _inputs(P, C, N, P, masked=0.2)
    bt = _sweep(emulated, cost, mask, switch, carry_in=_carry(P, C, P)).bt
    ends = torch.from_numpy(np.random.default_rng(P).integers(0, P, C).astype(np.int32))
    paths, state_out = _chase(emulated, bt, ends, P)
    want_paths, want_out = sampling.chase_plain(bt, ends)
    assert torch.equal(paths, want_paths) and torch.equal(state_out.long(), want_out)


@pytest.mark.parametrize("P,segment", [(9, 4), (300, 7), (4097, 3), (6405, 5)])
def test_emulated_s1_checkpointed_scan(emulated, P, segment):
    """The checkpointed scan composed of the emulated kernels (forward
    sweeps keeping only their exit rows, then each segment swept again
    from its entry row and chased from the state the later segment
    handed back) gives the plain DP's paths and best."""
    C, N = 2, 13
    cost, mask, switch = _inputs(P + 1, C, N, P, masked=0.3)
    bounds = [(lo, min(N, lo + segment)) for lo in range(0, N, segment)]

    def part(lo, hi):
        return (cost[:, lo:hi].contiguous(), mask[:, lo:hi].contiguous(),
                switch[:, lo:hi].contiguous())

    carries = [None]
    for lo, hi in bounds[:-1]:
        carries.append(_sweep(emulated, *part(lo, hi), carry_in=carries[-1], carry_out=True,
                              backtraces=False).carry_out)
    paths = torch.empty((C, N), dtype=torch.int32)
    state = best = None
    for (lo, hi), carry in zip(bounds[::-1], carries[::-1]):
        bt, seg_best, ends, _ = _sweep(emulated, *part(lo, hi), carry_in=carry)
        if state is None:
            state, best = ends, seg_best
        paths[:, lo:hi], state = _chase(emulated, bt, state, P)
    want = sampling.viterbi_iteration_plain(cost, mask, switch)
    assert torch.equal(paths, want[0])
    assert torch.equal(best.to(torch.int64) & UMAX, want[1])
