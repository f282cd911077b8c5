"""Kernels K1-K4 of ``pangenie_tpu_torch/csrc/fb.cu`` run on the CPU by
an emulator of the CUDA threads, against their plain versions:
K3/K4's register tiers, their cluster tier (128 < P <= 471: a
thread-block cluster of CTAs a chain, the state in registers, the column
sums merged by pushes into every rank's shared memory) and their grid
tier past it (a cooperative grid of CTAs a chain, the band's state in
registers, shared or global memory, the column sums merged through
global memory in one hop or two; builds with a small FBE_GRID_SMS give
the few CTAs the emulation can run), K1's and K2's one-warp tiers (P <=
32, A <= 8) and their CTA tiers, K1 also against the JAX package's
Pallas kernel in interpret mode.

The kernel source is compiled with g++ against the headers of
``tests/cuda_emulator/``, which stand in for ``cuda_runtime.h``,
``csrc/cp_async.cuh`` and ``csrc/cluster.cuh``: a cp.async is a plain
copy (a 16-byte one must be 16-byte aligned), a block's dynamic shared
memory is one array, and the one textual substitution makes a launch run
every thread of every block as a fiber; the cluster and cooperative
launches (``cudaLaunchKernelEx``) run through the emulator's own, the K
blocks of a cluster (every block of a cooperative grid) together, with
the cluster barrier, the mbarriers and the pushes into another block's
shared memory, and the arrivals and waits on a counter in global memory
of ``tests/cuda_emulator/grid.cuh``. So the kernels' own indexing,
barriers, lane-masked shuffles, ring and staging layout and cluster and
grid merges run as written; their timing and the asynchrony of the
copies are not modelled. ``tests/test_torch_cuda_kernels.py`` holds the real
kernels against the same inputs on the card.
"""

import ctypes
import os
import re
import subprocess

import numpy as np
import pytest
import torch

from pangenie_tpu_torch import _build
from pangenie_tpu_torch.hmm import fb_generic, fb_kernels
from pangenie_tpu_torch.hmm.forward_backward import (
    allele_emissions,
    backward_plain,
    columns_from_numpy,
    forward_backward,
    forward_plain,
)
from pangenie_tpu_torch.utils.synthetic import synthetic_columns
from test_torch_cuda_kernels import (
    _edge_inputs,
    _generic_columns,
    _k2_inputs,
    _kept_columns_close,
    _posteriors_close_or_zero,
    _tiny_columns,
)

HERE = os.path.dirname(os.path.abspath(__file__))


def _emulated_source(src: str) -> str:
    src, n = re.subn(
        r"kernel<<<B, threads, smem, \(cudaStream_t\)stream>>>\(args\.\.\.\);",
        "if (emu_run(B, threads, smem, [&]() { kernel(args...); }))"
        " return (int)cudaErrorInvalidValue;", src)
    assert n == 1, "the launch in csrc/fb.cu changed"
    assert src.count("cudaLaunchKernelEx(") == 1, "the cluster and grid launch changed"
    return src


# K1's one-warp tier's division (fbf_div) over arrays, for its test
_FBF_DIV_SHIM = """
extern "C" void test_fbf_div(const float* cur, const float* s, float* out, int n) {
    for (int i = 0; i < n; ++i) {
        const double sd = s[i];
        out[i] = fbf_div(cur[i], sd, 1.0 / sd);
    }
}
"""


def _build_emulated(out, defines=()):
    """csrc/fb.cu built against the emulator into ``out`` (with the -D
    macros ``defines``), its K1-K4 entry points bound, and
    ``pg_fb_forward_cta``: K1's 256-thread kernel at any P; and
    ``test_fbf_div``: the one-warp tier's division."""
    src = out / "fb_emulated.cpp"
    with open(os.path.join(_build.CUDA_SRC_DIR, "fb.cu")) as f:
        src.write_text(_emulated_source(f.read()) + _FBF_DIV_SHIM)
    lib = out / "libfb_emulated.so"
    subprocess.run(
        ["g++", "-std=c++17", "-O1", "-shared", "-fPIC", "-Wno-unknown-pragmas",
         *(f"-D{d}" for d in defines), "-I", os.path.join(HERE, "cuda_emulator"),
         "-o", str(lib), os.path.join(HERE, "cuda_emulator", "emu.cpp"), str(src)],
        check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib))
    lib.pg_fbe_forward.argtypes = fb_kernels.K3._argtypes
    lib.pg_fbe_backward.argtypes = fb_kernels.K4._argtypes
    lib.pg_fb_forward.argtypes = fb_kernels.K1._argtypes
    lib.pg_fb_forward_cta.argtypes = fb_kernels.K1._argtypes
    lib.pg_fb_backward.argtypes = fb_kernels.K2._argtypes
    lib.test_fbf_div.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int]
    lib.test_fbf_div.restype = None
    lib.pg_fb_threads.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.pg_fbe_launch.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.pg_fbe_launch.restype = None
    lib.pg_fbe_cluster_fits.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    return lib


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """csrc/fb.cu built against the emulator, its K1-K4 entry points bound."""
    return _build_emulated(tmp_path_factory.mktemp("fb_emulated"))


# the emulated card (tests/cuda_emulator/cuda_runtime.h) holds 132 CTAs of
# 1024 threads at once, one an SM: the grid tier's capacity in a build
# without FBE_GRID_SMS
EMU_CAPACITY = 132


@pytest.fixture(scope="module")
def emulated_grid(tmp_path_factory):
    """The emulated library built with FBE_GRID_SMS = sms (and
    FBE_GRID_ONE_HOP = one_hop where given), by (sms, one_hop)."""
    libs = {}

    def get(sms, one_hop=None):
        if (sms, one_hop) not in libs:
            defines = [f"FBE_GRID_SMS={sms}"]
            if one_hop is not None:
                defines.append(f"FBE_GRID_ONE_HOP={one_hop}")
            libs[sms, one_hop] = _build_emulated(
                tmp_path_factory.mktemp(f"fb_emulated_grid_{sms}_{one_hop}"), defines)
        return libs[sms, one_hop]
    return get


def _grid_build(monkeypatch, emulated_grid, sms, one_hop=None):
    """The build of FBE_GRID_SMS = sms (FBE_GRID_ONE_HOP = one_hop), with
    fb_kernels set to match."""
    monkeypatch.setattr(fb_kernels, "GRID_SMS", sms)
    if one_hop is not None:
        monkeypatch.setattr(fb_kernels, "GRID_ONE_HOP", one_hop)
    return emulated_grid(sms, one_hop)


@pytest.fixture(scope="module")
def emulated_ranks(tmp_path_factory):
    """The emulated library built with FBE_CLUSTER_RANKS = k, by k."""
    libs = {}

    def get(k):
        if k not in libs:
            libs[k] = _build_emulated(tmp_path_factory.mktemp(f"fb_emulated_{k}"),
                                      [f"FBE_CLUSTER_RANKS={k}"])
        return libs[k]
    return get


def _scratch(B, P, backward):
    """The grid tier's scratch, NaN-filled so that a read before a write
    shows, but for each chain's arrival counter, which starts at 0 (empty
    where P takes a register tier or the cluster tier)."""
    scratch = fb_kernels.grid_scratch(B, P, backward, "cpu")
    if scratch.numel():
        scratch[:, 4:] = float("nan")
    return scratch


def _forward(lib, E, u, alpha0):
    B, n, P, _ = E.shape
    alphas = torch.full((B, n, P, P), float("nan"))
    c_fwd = torch.full((B, n), float("nan"))
    scratch = _scratch(B, P, False)
    assert lib.pg_fbe_forward(E.data_ptr(), u.data_ptr(), alpha0.data_ptr(),
                              alphas.data_ptr(), c_fwd.data_ptr(), scratch.data_ptr(),
                              B, n, P, *fb_kernels.generic_launch(P, B), None) == 0
    return alphas, c_fwd


def _backward(lib, alphas, c_fwd, E, u, e_after, u_after, is_last, beta0):
    B, n, P, _ = E.shape
    last = is_last.to(torch.int32).contiguous()
    posts = torch.full((B, n, P, P), float("nan"))
    beta_out = torch.full((B, P, P), float("nan"))
    scratch = _scratch(B, P, True)
    assert lib.pg_fbe_backward(alphas.data_ptr(), c_fwd.data_ptr(), E.data_ptr(),
                               u.data_ptr(), e_after.data_ptr(), u_after.data_ptr(),
                               last.data_ptr(), beta0.data_ptr(), posts.data_ptr(),
                               beta_out.data_ptr(), scratch.data_ptr(), B, n, P,
                               *fb_kernels.generic_launch(P, B), None) == 0
    return posts, beta_out


def _assert_generic_match_plain(lib, inputs):
    """K3 and K4 (on K3's alphas) through ``lib`` against their plain
    versions at the card's tolerance (posteriors that are exactly 0 in
    the plain version, 0 in the kernel's too), and two launches of each
    give the same bits."""
    E, u, alpha0, e_after, u_after, is_last, beta0 = inputs
    a_k, c_k = _forward(lib, E, u, alpha0)
    a_p, c_p = fb_generic.forward_e_plain(E, u, alpha0)
    torch.testing.assert_close(a_k, a_p, rtol=2e-4, atol=1e-7)
    torch.testing.assert_close(c_k, c_p, rtol=2e-4, atol=1e-7)
    args = (a_k, c_k, E, u, e_after, u_after, is_last, beta0)
    p_k, b_k = _backward(lib, *args)
    p_p, b_p = fb_generic.backward_e_plain(*args)
    _posteriors_close_or_zero(p_k, p_p)
    torch.testing.assert_close(b_k, b_p, rtol=2e-4, atol=1e-7)
    a_2, c_2 = _forward(lib, E, u, alpha0)
    p_2, b_2 = _backward(lib, *args)
    assert torch.equal(a_2, a_k) and torch.equal(c_2, c_k)
    assert torch.equal(p_2, p_k) and torch.equal(b_2, b_k)


@pytest.mark.parametrize("P,n", [(1, 9), (17, 1), (33, 9), (89, 7), (113, 4)])
def test_emulated_generic_kernels_match_plain(emulated, P, n):
    """The card test's inputs (is_last inside the chunk, an all-zero E
    column, padding, an all-padding chain) through the emulated K3/K4:
    close to the plain versions at the card's tolerance, and two
    launches give the same bits. The columns start at every 16-byte
    misalignment (P^2 odd)."""
    _assert_generic_match_plain(emulated, _edge_inputs(P, n, "cpu"))


def test_emulated_kernels_with_a_ring_of_two(emulated):
    """The ring of two slots at a chunk whose columns outnumber it
    several times."""
    assert fb_kernels.RING == 2
    rng = np.random.default_rng(5)
    B, n, P = 2, 11, 21
    E = torch.from_numpy(rng.random((B, n, P, P)).astype(np.float32))
    u = fb_generic.factor_trans(
        torch.from_numpy(rng.random((B, n, 3)).astype(np.float32)) * 0.1).contiguous()
    ones = torch.ones((B, P, P))
    a_k, c_k = _forward(emulated, E, u, ones)
    a_p, c_p = fb_generic.forward_e_plain(E, u, ones)
    torch.testing.assert_close(a_k, a_p, rtol=2e-4, atol=1e-7)
    torch.testing.assert_close(c_k, c_p, rtol=2e-4, atol=1e-7)


def test_emulated_launch_rejects_another_layout(emulated):
    """fbe_config_ok refuses launches that do not match the kernel's
    layout (the wrapper passes generic_launch's): other shared-memory
    sizes, threads or CTAs a chain, on a register tier, on the cluster
    tier, and the wide tier without its scratch."""
    def code(P, launch, scratch=None):
        E, u, alpha0 = torch.ones((1, 2, P, P)), torch.zeros((1, 2, 3)), torch.ones((1, P, P))
        out, c = torch.empty_like(E), torch.empty((1, 2))
        return emulated.pg_fbe_forward(E.data_ptr(), u.data_ptr(), alpha0.data_ptr(),
                                       out.data_ptr(), c.data_ptr(), scratch, 1, 2, P,
                                       *launch, None)

    ranks, threads, smem = fb_kernels.generic_launch(8, 1)
    one_slot = 4 * (8 + 68)                 # header + a P=8 column at any misalignment
    for bad in ((ranks, threads, smem + 4), (ranks, threads, smem - one_slot),
                (ranks, threads // 2, smem), (2, threads, smem)):
        assert code(8, bad) != 0
    ranks, threads, smem = fb_kernels.generic_launch(200, 1)
    assert ranks == 16
    for bad in ((8, threads, smem), (ranks, threads + 32, smem), (ranks, threads, smem + 16),
                (1, 1024, 33_024)):
        assert code(200, bad) != 0
    assert code(472, fb_kernels.generic_launch(472, 1, EMU_CAPACITY)) != 0     # no scratch


@pytest.mark.parametrize("P,n", [(129, 7), (200, 3), (257, 3), (465, 2), (472, 3), (600, 2)])
def test_emulated_wide_tier_matches_plain(emulated, emulated_grid, monkeypatch, P, n):
    """K3/K4 past 128 paths on the edge inputs of the register tiers
    (entry carries alpha0 and beta0 that are not ones or zeros, is_last
    inside the chunk, an all-zero E column: the state turns uniform;
    padding and an all-padding chain); two launches give the same bits.
    Up to 471 paths the cluster tier (clusters of 16 CTAs for B=3, each
    rank a band of rows: 8 or 9 at P=129; the column sums merged through
    every rank's shared memory); past it the grid tier of a build whose
    card holds 24 CTAs at once: 8 CTAs a chain of the 3, bands of 59 (75)
    rows in shared memory, the column sums merged through global memory
    in one hop."""
    if P <= 471:
        layout = fb_kernels.cluster_layout(P, 3)
        assert layout.ranks == 16
        assert fb_kernels.generic_launch(P, 3) == (layout.ranks, 32 * layout.warps, layout.smem)
        assert fb_kernels.grid_scratch(3, P, True, "cpu").numel() == 0
        _assert_generic_match_plain(emulated, _edge_inputs(P, n, "cpu"))
        return
    lib = _grid_build(monkeypatch, emulated_grid, 24)
    grid = fb_kernels.grid_layout(P, 3, 24)
    assert (grid.ctas, fb_kernels.STORES[grid.store], grid.hops) == (8, "shared", 1)
    assert fb_kernels.generic_launch(P, 3) == (8, 32 * grid.groups * grid.segments, grid.smem)
    _assert_generic_match_plain(lib, _edge_inputs(P, n, "cpu"))


def test_emulated_one_cta_wide_tier_past_the_cluster_tier(emulated_grid, monkeypatch):
    """Past what a cluster of 16 CTAs holds (P = 472), where the card
    holds no more CTAs at once than the chains (a build of 4 for B=3):
    the grid tier on one CTA a chain (32 warps, the state in global
    memory: K3's in its alphas, K4's helper in the scratch; no arrivals,
    a launch that is not cooperative), on the edge inputs."""
    P = 472
    assert fb_kernels.cluster_layout(P - 1, 3) is not None
    assert fb_kernels.cluster_layout(P, 3) is None
    lib = _grid_build(monkeypatch, emulated_grid, 4)
    grid = fb_kernels.grid_layout(P, 3, 4)
    assert (grid.ctas, fb_kernels.STORES[grid.store], grid.hops) == (1, "global", 0)
    assert fb_kernels.generic_launch(P, 3)[:2] == (1, 1024)
    assert fb_kernels.grid_scratch(3, P, True, "cpu").shape[1] > P * P   # K4's helper
    _assert_generic_match_plain(lib, _edge_inputs(P, 2, "cpu"))


# (P, B, FBE_GRID_SMS, FBE_GRID_ONE_HOP, where the band lives, hops): one
# case for each place of the state; bands of 19-20 and 52-53 rows (uneven);
# two chains on one grid; two hops forced where one would do
GRID_CASES = [(472, 1, 24, None, "registers", 1), (472, 2, 12, None, "shared", 1),
              (472, 1, 9, 0, "shared", 2), (600, 1, 4, None, "global", 1),
              (600, 2, 4, None, "global", 1)]


@pytest.mark.parametrize("P,B,sms,one_hop,store,hops", GRID_CASES)
def test_emulated_grid_tier_matches_plain(emulated_grid, monkeypatch, P, B, sms, one_hop,
                                          store, hops):
    """The grid tier of builds whose card holds ``sms`` CTAs at once, on
    inputs that lean on the last rank's band (its E 1000x the others', a
    column whose E only it holds, an all-zero E column, is_last inside
    the chunk): the plain versions' results, and the same bits twice."""
    lib = _grid_build(monkeypatch, emulated_grid, sms, one_hop)
    grid = fb_kernels.grid_layout(P, B, sms)
    assert (fb_kernels.STORES[grid.store], grid.hops) == (store, hops)
    assert grid.ctas == sms // B
    inputs = _band_inputs(P, 4, grid.ctas, seed=P + sms)
    _assert_generic_match_plain(lib, tuple(x[:B].contiguous() for x in inputs))


def _band_inputs(P, n, ranks, seed):
    """K3/K4 inputs of B=2 chains that lean on the last rank's band (rows
    [(ranks - 1) P / ranks, P)): its E is 1000x the others' (the largest
    column partials), a column of chain 0 and one of chain 1 have E only
    there (their totals come from that rank alone), chain 0 has an
    all-zero E column (the uniform state) and is_last inside the chunk;
    entry carries drawn positive."""
    B = 2
    rng = np.random.default_rng(seed)

    def rand(*shape):
        return torch.from_numpy(rng.random(shape).astype(np.float32))

    E, alpha0, beta0, e_after = rand(B, n, P, P), rand(B, P, P), rand(B, P, P), rand(B, P, P)
    lo = (ranks - 1) * P // ranks
    E[:, :, lo:] *= 1000.0
    E[0, 1, :lo] = 0.0
    E[1, n - 2, :lo] = 0.0
    E[0, 3] = 0.0
    u = fb_generic.factor_trans(rand(B, n, 3) * 0.1).contiguous()
    u_after = rand(B, 3) * 0.1
    is_last = torch.zeros((B, n), dtype=torch.bool)
    is_last[0, n - 2] = True
    return E, u, alpha0 + 0.5, e_after, u_after, is_last, beta0 + 0.5


@pytest.mark.parametrize("P,k,ranks", [
    (129, 8, 8),         # uneven bands: 16 and 17 rows
    (129, 4, 4),         # 2 rows a warp
    (200, 4, 4),
    (256, 4, 4),         # 32 warps of 2 rows
    (200, 8, 8),
    (200, 2, 4),         # 2 CTAs do not hold a band: the fewest that do
    (300, 4, 16),
])
def test_emulated_cluster_sizes(emulated_ranks, monkeypatch, P, k, ranks):
    """The clusters of the source built with FBE_CLUSTER_RANKS = k, as
    tools/fbe_times.py --ranks times them (fb_kernels.CLUSTER_RANKS set
    to match), on inputs that put the largest column partials, the only
    E of a column, an all-zero E column and is_last in the last rank's
    band's reach: the plain versions' results, and the same bits twice."""
    monkeypatch.setattr(fb_kernels, "CLUSTER_RANKS", k)
    assert fb_kernels.cluster_layout(P, 2).ranks == ranks
    _assert_generic_match_plain(emulated_ranks(k), _band_inputs(P, 6, ranks, seed=P + k))


@pytest.mark.parametrize("P", [129, 257])
def test_emulated_cluster_last_band(emulated, P):
    """The library's own clusters (16 CTAs; bands of 8 and 9 rows at
    P=129) on the inputs that lean on the last rank's band."""
    ranks = fb_kernels.cluster_layout(P, 2).ranks
    _assert_generic_match_plain(emulated, _band_inputs(P, 6, ranks, seed=P))


@pytest.mark.parametrize("k", [2, 4, 8, 16])
def test_emulated_launch_layout_matches_the_rule(emulated, emulated_ranks, monkeypatch, k):
    """fb_kernels.generic_launch is csrc/fb.cu's rule (pg_fbe_launch) for
    every P up to 1,100 and at 6,405, for batches that fill the card and
    batches past it, in the library built with FBE_CLUSTER_RANKS = k (the
    grid tier on the emulated card's 132 CTAs at once); the cluster
    tier's occupancy reading is 0 where P does not take it."""
    lib = emulated if k == fb_kernels.CLUSTER_RANKS else emulated_ranks(k)
    monkeypatch.setattr(fb_kernels, "CLUSTER_RANKS", k)
    monkeypatch.setattr(fb_kernels, "GRID_SMS", EMU_CAPACITY)
    out = (ctypes.c_int * 3)()
    for B in (1, 2, 11, 17, 34, 40):
        for P in [*range(1, 1101), 6405]:
            lib.pg_fbe_launch(P, B, out)
            assert tuple(out) == fb_kernels.generic_launch(P, B), (P, B)
    fits = ctypes.c_int(-1)
    for P, want in ((128, 0), (200, 132 // fb_kernels.generic_launch(200, 1)[0]), (472, 0)):
        assert lib.pg_fbe_cluster_fits(P, 1, 1, ctypes.byref(fits)) == 0
        assert fits.value == want


def test_emulated_wide_tier_in_the_chunked_route(emulated, monkeypatch):
    """fb_generic.forward_backward_chunked at P = 130 in chunks of 4
    columns, through the emulated K3/K4 past 128 paths (each chunk's
    carries are the kernels' own outputs), against the same route with
    the plain versions."""
    B, N, P, chunk = 2, 10, 130, 4
    assert fb_kernels.cluster_layout(P, B) is not None
    want, want_corr = fb_generic.forward_backward_chunked(
        _generic_columns(B, N, P, "cpu"), chunk=chunk)
    monkeypatch.setattr(fb_kernels, "forward_e",
                        lambda E, u, alpha0: _forward(emulated, E, u, alpha0))
    monkeypatch.setattr(fb_kernels, "backward_e",
                        lambda *args: _backward(emulated, *args))
    got, corr = fb_generic.forward_backward_chunked(
        _generic_columns(B, N, P, "cpu"), chunk=chunk)
    assert fb_generic.last_walk == (B, N, 3)
    _posteriors_close_or_zero(got, want)
    torch.testing.assert_close(corr, want_corr)


def test_emulated_grid_tier_in_the_chunked_route(emulated_grid, monkeypatch):
    """fb_generic.forward_backward_chunked at P = 480 in chunks of 4
    columns through the emulated grid tier (2 CTAs a chain of the 2, the
    state in global memory; each chunk's carries are the kernels' own
    outputs), against the same route with the plain versions."""
    B, N, P, chunk = 2, 10, 480, 4
    lib = _grid_build(monkeypatch, emulated_grid, 4)
    assert fb_kernels.grid_layout(P, B, 4).ctas == 2
    want, want_corr = fb_generic.forward_backward_chunked(
        _generic_columns(B, N, P, "cpu"), chunk=chunk)
    monkeypatch.setattr(fb_kernels, "forward_e",
                        lambda E, u, alpha0: _forward(lib, E, u, alpha0))
    monkeypatch.setattr(fb_kernels, "backward_e", lambda *args: _backward(lib, *args))
    got, corr = fb_generic.forward_backward_chunked(
        _generic_columns(B, N, P, "cpu"), chunk=chunk)
    assert fb_generic.last_walk == (B, N, 3)
    _posteriors_close_or_zero(got, want)
    torch.testing.assert_close(corr, want_corr)


def _k2(lib, alphas, c_fwd, ea, al, trans, is_last):
    B, N, A, _ = ea.shape
    P = al.shape[2]
    al32 = al.to(torch.int32).contiguous()
    last = is_last.to(torch.int32).contiguous()
    posts = torch.full((B, N, A, A), float("nan"))
    assert lib.pg_fb_backward(alphas.data_ptr(), c_fwd.data_ptr(), ea.data_ptr(),
                              al32.data_ptr(), trans.data_ptr(), last.data_ptr(),
                              posts.data_ptr(), B, N, P, A, None) == 0
    return posts


@pytest.mark.parametrize("A", [1, 2, 8])
@pytest.mark.parametrize("P", [1, 2, 5, 9, 15, 16, 17, 31, 32, 33])
def test_emulated_k2_matches_plain(emulated, P, A):
    """K2 against backward_plain on B=3 chains of 20 columns (more than
    its ring of 8 slots), with is_last inside a chain and an all-zero
    emission column: P <= 32 on the one-warp tier, at every lanes-a-row
    layout and both allele buckets (2, 8); P = 33 still on the CTA tier.
    Two launches give the same bits."""
    assert emulated.pg_fb_threads(P, A) == (32 if P <= 32 else 256)
    inputs = _k2_inputs(3, 20, P, A, seed=100 * P + A)
    got = _k2(emulated, *inputs)
    want = backward_plain(*inputs)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=1e-7)
    assert torch.equal(_k2(emulated, *inputs), got)


def test_emulated_k2_short_chains(emulated):
    """Chains shorter than the ring (N = 1 and 3) on the one-warp tier."""
    for N in (1, 3):
        inputs = _k2_inputs(2, N, 16, 2, seed=N)
        torch.testing.assert_close(_k2(emulated, *inputs), backward_plain(*inputs),
                                   rtol=2e-4, atol=1e-7)


@pytest.mark.parametrize("P,A", [(16, 2), (16, 8), (32, 2), (33, 8)])
def test_emulated_k2_after_tiny_emissions(emulated, P, A):
    """K2 where two columns' emissions are near 1e-25 (_tiny_columns, as
    on real columns), on both tiers, against backward_plain (columns
    divided by their sums): its helper is formed from the normalized
    beta, so nothing underflows."""
    alphas, c_fwd, ea, al, trans, is_last = _k2_inputs(3, 20, P, A, seed=7 * P + A)
    ea = _tiny_columns(ea, 1, 8)
    alphas, c_fwd = forward_plain(ea, al, trans)
    inputs = (alphas, c_fwd, ea, al, trans, is_last)
    _kept_columns_close(_k2(emulated, *inputs), backward_plain(*inputs))


def _k1(lib, ea, al, trans, entry="pg_fb_forward"):
    B, N, A, _ = ea.shape
    P = al.shape[2]
    al32 = al.to(torch.int32).contiguous()
    alphas = torch.full((B, N, P, P), float("nan"))
    c_fwd = torch.full((B, N), float("nan"))
    assert getattr(lib, entry)(ea.data_ptr(), al32.data_ptr(), trans.data_ptr(),
                               alphas.data_ptr(), c_fwd.data_ptr(), B, N, P, A, None) == 0
    return alphas, c_fwd


def _assert_k1_close(got, want):
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=2e-4, atol=1e-7)


@pytest.mark.parametrize("A", [1, 2, 8])
@pytest.mark.parametrize("P", [1, 2, 5, 9, 15, 16, 17, 24, 25, 31, 32, 33])
def test_emulated_k1_matches_plain(emulated, P, A):
    """K1 against forward_plain on B=3 chains of 20 columns (more than
    its ring of 16 slots), with is_last inside a chain (K1 reads none)
    and an all-zero emission column (uniform alphas, c_fwd 1 there): P <=
    32 on the one-warp tier, at every lanes-a-row layout and 24 rows a
    lane at P = 17..24, A = 1 (one allele), 2 and 8, bit for bit the
    256-thread kernel's outputs; P = 33 on that kernel, by the rule K2
    reads. Two launches give the same bits."""
    assert emulated.pg_fb_threads(P, A) == fb_kernels.fused_threads(P, A) == (
        32 if P <= 32 else 256)
    _alphas, _c, ea, al, trans, _last = _k2_inputs(3, 20, P, A, seed=100 * P + A)
    got = _k1(emulated, ea, al, trans)
    want = forward_plain(ea, al, trans)
    _assert_k1_close(got, want)
    assert torch.equal(got[0][1, 20 // 3], torch.full((P, P), 1.0 / (P * P)))
    assert got[1][1, 20 // 3] == 1.0
    again = _k1(emulated, ea, al, trans)
    assert torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])
    cta = _k1(emulated, ea, al, trans, "pg_fb_forward_cta")
    assert torch.equal(cta[0], got[0]) and torch.equal(cta[1], got[1])


def test_emulated_k1_division_rounds_as_the_float_division(emulated):
    """The one-warp tier's cur / s (fbf_div: a reciprocal and a corrected
    product in double precision, then rounded to float) gives the bits of
    the float32 division for 0 < s < 2^24: on quotients of every exponent
    from 2^-160 to 2, normal and subnormal cells and totals, exact
    midpoints between subnormal floats (cur = m s, where the division
    rounds a tie to even), quotients one float apart from them, and
    cells of -0, 0 and of either sign."""
    rng = np.random.default_rng(13)
    n = 200_000
    s = np.exp2(rng.uniform(-149, 24, n)).astype(np.float32)
    cur = (s.astype(np.float64) * np.exp2(rng.uniform(-160, 1, n))).astype(np.float32)
    cur[: n // 8] = rng.integers(0, 1 << 23, n // 8).astype(np.uint32).view(np.float32)
    odd_m = 2 * rng.integers(0, 1 << 11, n) + 1
    odd_s = 2 * rng.integers(0, 1 << 10, n) + 1
    k = rng.integers(1, 13, n)
    s_mid = (odd_s * np.exp2(k)).astype(np.float32)
    cur_mid = (odd_m * odd_s * np.exp2(k - 150.0)).astype(np.float32)
    assert np.array_equal(cur_mid.astype(np.float64), odd_m * odd_s * np.exp2(k - 150.0))
    near = np.nextafter(cur_mid, np.float32(np.inf))
    cur = np.concatenate([cur, cur_mid, near, [0.0, -0.0, 1e-45, -1e-45]]).astype(np.float32)
    s = np.concatenate([s, s_mid, s_mid, [1.0, 1.0, 2.0, 2.0]]).astype(np.float32)
    cur[::3] = -cur[::3]
    got = np.empty_like(cur)
    emulated.test_fbf_div(cur.ctypes.data, s.ctypes.data, got.ctypes.data, len(cur))
    want = cur / s
    assert int((want == 0).sum()) > 1000 and int((np.abs(want) < 2.0 ** -126).sum()) > n // 4
    bad = np.flatnonzero(got.view(np.int32) != want.view(np.int32))
    assert bad.size == 0, [(cur[i], s[i], got[i], want[i]) for i in bad[:5]]


@pytest.mark.parametrize("N", [1, 3])
@pytest.mark.parametrize("P", [1, 16])
def test_emulated_k1_short_chains(emulated, N, P):
    """Chains shorter than the ring (N = 1 and 3) on the one-warp tier,
    at P = 1 (one lane a row, 32 a column) and 16, bit for bit the
    256-thread kernel's."""
    _alphas, _c, ea, al, trans, _last = _k2_inputs(2, N, P, 2, seed=N + P)
    got = _k1(emulated, ea, al, trans)
    _assert_k1_close(got, forward_plain(ea, al, trans))
    cta = _k1(emulated, ea, al, trans, "pg_fb_forward_cta")
    assert torch.equal(cta[0], got[0]) and torch.equal(cta[1], got[1])


@pytest.mark.parametrize("further", [1.0, 1e-16])
@pytest.mark.parametrize("P,A", [(16, 2), (16, 8), (32, 2), (33, 8)])
def test_emulated_k1_after_tiny_emissions(emulated, P, A, further):
    """K1 where two columns' emissions are near 1e-25 (_tiny_columns, as
    on real columns), or 1e-16 times that (subnormal: the total of cur is
    near 5e-42, whose reciprocal overflows float32), on both tiers,
    against forward_plain: each column is divided by its total before it
    is mixed, so nothing underflows or overflows."""
    _alphas, _c, ea, al, trans, _last = _k2_inputs(3, 20, P, A, seed=7 * P + A)
    ea = _tiny_columns(ea, 1, 8)
    ea[1, 8:10] *= further
    got = _k1(emulated, ea, al, trans)
    assert bool(torch.isfinite(got[0]).all())
    _assert_k1_close(got, forward_plain(ea, al, trans))


@pytest.mark.parametrize("P,A", [(16, 3), (33, 3)])
def test_emulated_k1_then_k2_match_forward_backward(emulated, P, A):
    """Emulated K1, then emulated K2 on its alphas and c_fwd, against the
    plain forward_backward on synthetic columns (B=3, N=20, is_last at
    column 14 with a padded tail), on both tiers."""
    B, N = 3, 20
    cols = synthetic_columns(n_columns=N, n_paths=P, n_kmers=8, n_alleles=A,
                             batch_dims=(B,), seed=P + A, dtype=np.float32)
    is_last = np.zeros((B, N), dtype=bool)
    is_last[:, N - 6] = True
    cols = columns_from_numpy(cols._replace(is_last=is_last), "cpu", torch.float32)
    ea = allele_emissions(cols)
    alphas, c_fwd = _k1(emulated, ea, cols.allele_local, cols.trans)
    posts = _k2(emulated, alphas, c_fwd, ea, cols.allele_local, cols.trans, cols.is_last)
    want, _corr = forward_backward(cols)
    torch.testing.assert_close(posts[:, :N - 5], want[:, :N - 5], rtol=2e-4, atol=1e-7)


def _pallas_forward(ea, al, trans):
    """The JAX package's K1 (pallas_fb._fwd_kernel) in interpret mode on
    numpy ea [B, N, A, A], al [B, N, P] and trans [B, N, 3] (float32), laid
    out as forward_backward_batch_pallas lays them out: (alphas [B, N,
    P, P], c_fwd [B, N])."""
    from functools import partial

    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu
    from pangenie_tpu.hmm import pallas_fb

    B, N, P = al.shape
    A = ea.shape[-1]
    LB, S = pallas_fb.LANE, pallas_fb._pick_segment(P)
    NP = -(-N // S) * S

    def to_lanes(x):
        x = jnp.moveaxis(jnp.asarray(x, jnp.float32), 0, -1)
        pad = [(0, NP - x.shape[0])] + [(0, 0)] * (x.ndim - 2) + [(0, LB - B)]
        return jnp.pad(x, pad)

    oh = np.eye(A, dtype=np.float32)[al]                                  # [B, N, P, A]
    args = (to_lanes(ea.reshape(B, N, A * A)), to_lanes(np.swapaxes(oh, 2, 3)),
            to_lanes(pallas_fb._factor_trans(jnp.asarray(trans))))

    def spec(block, index_map):
        return pl.BlockSpec(block, index_map, memory_space=pltpu.VMEM)

    with jax.enable_x64(False):
        alphas, c_fwd = pl.pallas_call(
            partial(pallas_fb._fwd_kernel, S=S, P=P, A=A),
            grid=(1, NP // S),
            in_specs=[spec((S, A * A, LB), lambda b, n: (n, 0, b)),
                      spec((S, A, P, LB), lambda b, n: (n, 0, 0, b)),
                      spec((S, 3, LB), lambda b, n: (n, 0, b))],
            out_specs=[spec((S, P, P, LB), lambda b, n: (n, 0, 0, b)),
                       spec((S, LB), lambda b, n: (n, b))],
            out_shape=[jax.ShapeDtypeStruct((NP, P, P, LB), jnp.float32),
                       jax.ShapeDtypeStruct((NP, LB), jnp.float32)],
            scratch_shapes=[pltpu.VMEM((P, P, LB), jnp.float32)],
            interpret=True,
        )(*args)
    alphas = np.moveaxis(np.asarray(alphas), -1, 0)[:B, :N]
    return alphas, np.asarray(c_fwd).T[:B, :N]


def test_emulated_k1_matches_the_pallas_kernel(emulated):
    """K1's one-warp tier at P=16 A=4 (the bench batch's P and padded A),
    B=2 N=64, against the JAX package's _fwd_kernel run in interpret
    mode on the same numpy inputs."""
    B, N, P, A = 2, 64, 16, 4
    _alphas, _c, ea, al, trans, _last = _k2_inputs(B, N, P, A, seed=1613)
    got = _k1(emulated, ea, al, trans)
    want = _pallas_forward(ea.numpy(), al.numpy(), trans.numpy())
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=2e-4, atol=1e-7)
    np.testing.assert_allclose(got[1].numpy(), want[1], rtol=2e-4, atol=1e-7)


@pytest.mark.parametrize("P", [16, 129, 257, 472])
def test_emulated_generic_kernels_after_tiny_emissions(emulated, emulated_grid, monkeypatch,
                                                      P):
    """K4's register, cluster (16 CTAs) and grid tiers (8 CTAs a chain
    in a build whose card holds 24 at once) where two columns' emissions
    are near 1e-25, against backward_e_plain on K3's alphas."""
    lib = emulated if P <= 471 else _grid_build(monkeypatch, emulated_grid, 24)
    E, u, alpha0, e_after, u_after, is_last, beta0 = _edge_inputs(P, 9, "cpu")
    E = _tiny_columns(E, 0, 1)
    a, c = _forward(lib, E, u, alpha0)
    args = (a, c, E, u, e_after, u_after, is_last, beta0)
    p_k, b_k = _backward(lib, *args)
    p_p, b_p = fb_generic.backward_e_plain(*args)
    _kept_columns_close(p_k, p_p)
    torch.testing.assert_close(b_k, b_p, rtol=2e-4, atol=1e-7)
