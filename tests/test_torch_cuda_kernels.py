"""Kernels K1-K4 (csrc/fb.cu), S1 (csrc/sampling_dp.cu), V1
(csrc/viterbi.cu) and D1-extract, D1-count and D1-count-keys
(csrc/kmer_count.cu) against their plain torch versions, on the card.

Marked ``cuda``: a CUDA kernel has no interpret mode, so these skip
where there is no GPU. Run them on a GPU machine with
``python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py``
(the GPU machine has no JAX, which tests/conftest.py imports).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pangenie_tpu_torch import _build
from pangenie_tpu_torch.hmm import fb_generic, fb_kernels, sampling, v1_kernels, viterbi
from pangenie_tpu_torch.hmm.forward_backward import (
    allele_emissions,
    backward_plain,
    columns_from_numpy,
    forward_plain,
)
from pangenie_tpu_torch.utils.multiallelic import allele_mix, multiallelic_columns
from pangenie_tpu_torch.utils.synthetic import synthetic_columns

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("B,N,P,K,A", [(3, 40, 8, 8, 2), (2, 33, 16, 4, 3),
                                       (1, 20, 96, 6, 4), (5, 17, 128, 4, 2)])
def test_fb_kernels_match_plain(cuda, B, N, P, K, A):
    cols = synthetic_columns(n_columns=N, n_paths=P, n_kmers=K, n_alleles=A,
                             batch_dims=(B,), seed=3, dtype=np.float32)
    is_last = np.zeros((B, N), dtype=bool)
    is_last[:, N - 5] = True                 # padded tail after is_last
    cols = columns_from_numpy(cols._replace(is_last=is_last), cuda, torch.float32)
    ea = allele_emissions(cols)
    launches = fb_kernels.K1.launches, fb_kernels.K2.launches
    a, c = fb_kernels.forward(ea, cols.allele_local, cols.trans)
    p = fb_kernels.backward(a, c, ea, cols.allele_local, cols.trans, cols.is_last)
    torch.cuda.synchronize()
    assert (fb_kernels.K1.launches, fb_kernels.K2.launches) == (
        launches[0] + 1, launches[1] + 1)
    a_ref, c_ref = forward_plain(ea, cols.allele_local, cols.trans)
    p_ref = backward_plain(a_ref, c_ref, ea, cols.allele_local, cols.trans,
                           cols.is_last)
    torch.testing.assert_close(a, a_ref, rtol=2e-4, atol=1e-7)
    torch.testing.assert_close(c, c_ref, rtol=2e-4, atol=1e-7)
    torch.testing.assert_close(p[:, : N - 4], p_ref[:, : N - 4], rtol=2e-4, atol=1e-7)


def test_fb_kernels_reject_float64(cuda):
    cols = columns_from_numpy(synthetic_columns(n_columns=8, batch_dims=(1,)),
                              cuda, torch.float64)
    ea = allele_emissions(cols)
    with pytest.raises(ValueError, match="dtype"):
        fb_kernels.forward(ea, cols.allele_local, cols.trans)


@pytest.mark.parametrize("C,N,P,masked", [
    (1, 50, 5, 0.0), (3, 200, 123, 0.3), (2, 64, 1, 0.2), (2, 40, 33, 0.97),
    # every sweep layout: one warp of 1-4 paths a lane, 2-8 warps, a
    # cluster of 5-8 CTAs past 1024 paths, uint8 and uint16 backtraces; N = 1
    # and N off the chase's segment length
    (2, 37, 31, 0.3), (2, 37, 32, 0.3), (2, 37, 128, 0.3), (2, 37, 129, 0.3),
    (2, 37, 300, 0.3), (1, 90, 1024, 0.3), (3, 1, 123, 0.3), (2, 1, 300, 0.0),
    (2, 37, 2048, 0.3), (1, 37, 4096, 0.3), (2, 1, 6405, 0.3),
    # clusters of 7 and 8 CTAs of 5, 7, 9 and 17 warps
    (2, 37, 4097, 0.3), (1, 37, 6405, 0.3), (2, 23, 8193, 0.3), (1, 23, 16385, 0.3),
])
def test_s1_matches_plain(cuda, C, N, P, masked):
    rng = np.random.default_rng(P)
    cost = torch.from_numpy(rng.integers(0, 4, (C, N, P)).astype(np.int32)).to(cuda)
    mask = torch.from_numpy(rng.random((C, N, P)) >= masked).to(cuda)
    switch = torch.from_numpy(rng.integers(0, 6, (C, N)).astype(np.int32)).to(cuda)
    launches = sampling.S1.launches, sampling.S1_CHASE.launches
    paths, scores = sampling.viterbi_iteration(cost, mask, switch)
    torch.cuda.synchronize()
    assert (sampling.S1.launches, sampling.S1_CHASE.launches) == (
        launches[0] + 1, launches[1] + 1)
    ref_paths, ref_scores = sampling.viterbi_iteration_plain(cost, mask, switch)
    assert torch.equal(paths, ref_paths)
    assert torch.equal(scores, ref_scores)


def test_s1_saturates(cuda):
    """Costs and switches near 2^32 saturate at UMAX on the card too."""
    C, N, P = 2, 9, 40
    cost = np.full((C, N, P), 0xF0000000, dtype=np.uint32)
    cost[:, :, 1] = 0x7FFFFFFF
    switch = np.full((C, N), 0xFFFFFFF0, dtype=np.uint32)
    args = (torch.from_numpy(cost.view(np.int32)).to(cuda),
            torch.ones((C, N, P), dtype=torch.bool, device=cuda),
            torch.from_numpy(switch.view(np.int32)).to(cuda))
    got, want = sampling.viterbi_iteration(*args), sampling.viterbi_iteration_plain(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("C,N,P", [(2, 300, 1025), (1, 70, 4097), (2, 120, 6405),
                                   (2, 60, 8193), (1, 40, 16385)])
def test_s1_takes_more_than_1024_paths(cuda, C, N, P):
    """Past 1024 paths (a cluster of 5-8 CTAs a chromosome, 16-bit
    backtraces) S1 gives the plain DP's paths and scores."""
    rng = np.random.default_rng(P)
    cost = torch.from_numpy(rng.integers(0, 4, (C, N, P)).astype(np.int32)).to(cuda)
    mask = torch.from_numpy(rng.random((C, N, P)) >= 0.3).to(cuda)
    switch = torch.from_numpy(rng.integers(0, 6, (C, N)).astype(np.int32)).to(cuda)
    got = sampling.viterbi_iteration(cost, mask, switch)
    want = sampling.viterbi_iteration_plain(cost, mask, switch)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("P,ranks", [(6405, 2), (6405, 4), (6405, 16), (4097, 16),
                                     (2049, 2), (4096, 4), (2049, 1)])
def test_s1_cluster_sizes(cuda, monkeypatch, P, ranks):
    """The clusters of the source built with S1_CLUSTER_RANKS = ranks, as
    tools/s1_times.py --ranks times them (the runtime-W instance, the
    non-portable sizes 11 and 13, 2 and 4 CTAs, and a cluster of one CTA
    of 17 warps), with and without entry and exit rows: the plain sweep's
    backtraces, exit row, best and path."""
    monkeypatch.setattr(sampling, "CLUSTER_RANKS", ranks)
    sweep = _build.CudaKernel("sampling_dp", "pg_s1_sweep", "s1", sampling.S1._argtypes,
                              defines={"S1_CLUSTER_RANKS": ranks})
    C, N = 2, 45
    rng = np.random.default_rng(P + ranks)
    cost = torch.from_numpy(rng.integers(0, 4, (C, N, P)).astype(np.int32)).to(cuda)
    mask = torch.from_numpy(rng.random((C, N, P)) >= 0.3).to(cuda)
    switch = torch.from_numpy(rng.integers(0, 6, (C, N)).astype(np.int32)).to(cuda)
    carry = torch.from_numpy(rng.integers(100, 104, (C, P)).astype(np.int32)).to(cuda)
    for carry_in in (None, carry):
        got = sampling.s1_sweep(cost, mask, switch, carry_in=carry_in, carry_out=True,
                                sweep=sweep)
        bts, last = sampling.sweep_plain(cost, mask, switch, carry_in)
        assert torch.equal(got.bt[:, :, :P].to(torch.int64) & 0xFFFF, bts.to(torch.int64))
        assert torch.equal(got.carry_out.to(torch.int64) & sampling.UINT_MAX, last)
        paths = sampling.s1_chase(got.bt, got.ends, P)[0]
        assert torch.equal(paths, sampling.chase_plain(got.bt, got.ends)[0])
    assert sweep.launches == 2


def test_s1_scores_in_a_scratch_row(cuda):
    """P = 65,537: scores in a scratch row, 32-bit backtraces."""
    C, N, P = 1, 6, 65_537
    rng = np.random.default_rng(0)
    cost = torch.from_numpy(rng.integers(0, 4, (C, N, P)).astype(np.int32)).to(cuda)
    mask = torch.from_numpy(rng.random((C, N, P)) >= 0.3).to(cuda)
    switch = torch.from_numpy(rng.integers(0, 6, (C, N)).astype(np.int32)).to(cuda)
    got = sampling.viterbi_iteration(cost, mask, switch)
    want = sampling.viterbi_iteration_plain(cost, mask, switch)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("C,N,P,segment", [(2, 200, 123, 23), (1, 90, 2049, 16),
                                           (2, 50, 6405, 9), (1, 40, 300, 40),
                                           (2, 50, 4097, 7), (1, 40, 8193, 9),
                                           (1, 30, 16385, 8)])
def test_s1_checkpointed_scan_matches_the_full_sweep(cuda, C, N, P, segment):
    """The checkpointed scan through the kernels (exit rows, entry rows,
    chases from handed-back states) gives S1's paths and best."""
    rng = np.random.default_rng(N + P)
    cost = torch.from_numpy(rng.integers(0, 4, (C, N, P)).astype(np.int32)).to(cuda)
    mask = torch.from_numpy(rng.random((C, N, P)) >= 0.3).to(cuda)
    switch = torch.from_numpy(rng.integers(0, 6, (C, N)).astype(np.int32)).to(cuda)

    def source(lo, hi):
        return (cost[:, lo:hi].contiguous(), mask[:, lo:hi].contiguous(),
                switch[:, lo:hi].contiguous())

    launches = sampling.S1.launches, sampling.S1_CHASE.launches
    got = sampling.viterbi_iteration_segmented(source, C, N, P, segment, cuda)
    torch.cuda.synchronize()
    S = -(-N // segment)
    assert (sampling.S1.launches - launches[0], sampling.S1_CHASE.launches - launches[1]) == (
        2 * S - 1, S)
    want = sampling.viterbi_iteration(cost, mask, switch)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _records(n, P, seed):
    from pangenie_tpu_torch.kmers.unique import UniqueKmersRecord

    rng = np.random.default_rng(seed)
    records = []
    for i in range(n):
        record = UniqueKmersRecord(1000 + 137 * i, rng.integers(0, 3, P).tolist())
        for _ in range(int(rng.integers(0, 5))):
            record.insert_kmer(int(rng.integers(0, 8)), [int(rng.integers(0, 3))])
        records.append(record)
    return records


@pytest.mark.parametrize("P", [40, 1100])
def test_sampling_beyond_the_budget_on_the_card(cuda, P):
    """sample_panels_batched on the card with a budget under every
    chromosome's group peak (the checkpointed scan, its inputs uploaded
    from pinned host memory on a side stream a segment ahead) samples the
    CPU's paths."""
    chroms = {"chrA": 300, "chrB": 170}
    states = [sampling._ChromState(c, _records(n, P, n), 1.26, 0.01) for c, n in chroms.items()]
    budget = min(sampling._group_peak([st], 4) for st in states) // 2
    assert sampling.plan_groups(states, 4, 2 << 30, budget)[0] == []
    launches = sampling.S1.launches
    on_card = sampling.sample_panels_batched(
        {c: _records(n, P, n) for c, n in chroms.items()}, 4, 1.26, 0.01, True, {}, 5,
        device=cuda, budget=budget)
    torch.cuda.synchronize()
    assert sampling.S1.launches - launches > 2 * 4 * len(chroms)  # several segments
    on_cpu = sampling.sample_panels_batched(
        {c: _records(n, P, n) for c, n in chroms.items()}, 4, 1.26, 0.01, True, {}, 5)
    assert on_card == on_cpu


def _generic_columns(B, N, P, device):
    """Up to A=16 columns, 80% of them cut to 2 alleles (several buckets),
    with k-mers and read counts that keep the raw posteriors far above
    float32's underflow (utils/multiallelic.py)."""
    caps = allele_mix(N, P, mix=((0.8, 2), (0.2, 16)))
    cols = multiallelic_columns(N, P, 8, caps, batch_dims=(B,), seed=P)
    return columns_from_numpy(cols, device, torch.float32)


def _assert_posteriors_close(got, want):
    """Raw posteriors [B, N, X, X]: every column's sum above 1e-20 (no
    underflow) and equal at rtol; each column divided by its sum equal
    at rtol/atol."""
    s_got = got.sum(dim=(-2, -1), keepdim=True)
    s_want = want.sum(dim=(-2, -1), keepdim=True)
    assert float(s_want.min()) > 1e-20
    torch.testing.assert_close(s_got, s_want, rtol=2e-4, atol=0)
    torch.testing.assert_close(got / s_got, want / s_want, rtol=2e-4, atol=1e-7)


def _generic_launches():
    return fb_kernels.K3.launches, fb_kernels.K4.launches


@pytest.mark.parametrize("B,N,P,chunk", [(2, 70, 16, 16), (1, 47, 89, 16),
                                         (3, 40, 128, 13), (2, 64, 32, 32)])
def test_generic_kernels_match_plain(cuda, B, N, P, chunk):
    """The chunked forward-backward with K3/K4 on the card vs with their plain
    versions on the CPU, in float32, over several chunks."""
    launches = _generic_launches()
    posts, corr = fb_generic.forward_backward_chunked(
        _generic_columns(B, N, P, cuda), chunk=chunk)
    torch.cuda.synchronize()
    n_chunks = -(-N // chunk)
    assert fb_generic.last_walk == (B, N, n_chunks)
    k3, k4 = _generic_launches()
    assert (k3 - launches[0], k4 - launches[1]) == (2 * n_chunks - 1, n_chunks)
    ref_p, ref_c = fb_generic.forward_backward_chunked(
        _generic_columns(B, N, P, "cpu"), chunk=chunk)
    _assert_posteriors_close(posts.cpu(), ref_p)
    torch.testing.assert_close(corr.cpu(), ref_c, rtol=2e-4, atol=1e-7)


def test_generic_kernels_carry_in_and_out(cuda):
    """K3/K4 with arbitrary entry carries, successor column and is_last
    inside the chunk, against the plain versions on the same tensors."""
    B, n, P = 2, 33, 40
    rng = np.random.default_rng(0)

    def rand(*shape):
        return torch.from_numpy(rng.random(shape).astype(np.float32)).to(cuda)

    E, alpha0, beta0, e_after = rand(B, n, P, P), rand(B, P, P), rand(B, P, P), rand(B, P, P)
    u = fb_generic.factor_trans(rand(B, n, 3) * 0.1).contiguous()
    u_after = rand(B, 3) * 0.1
    is_last = torch.zeros((B, n), dtype=torch.bool, device=cuda)
    is_last[0, 10] = True
    a_k, c_k = fb_kernels.forward_e(E, u, alpha0)
    a_p, c_p = fb_generic.forward_e_plain(E, u, alpha0)
    torch.testing.assert_close(a_k, a_p, rtol=2e-4, atol=1e-7)
    torch.testing.assert_close(c_k, c_p, rtol=2e-4, atol=1e-7)
    args = (a_k, c_k, E, u, e_after, u_after, is_last, beta0)
    p_k, b_k = fb_kernels.backward_e(*args)
    p_p, b_p = fb_generic.backward_e_plain(*args)
    _assert_posteriors_close(p_k, p_p)
    torch.testing.assert_close(b_k, b_p, rtol=2e-4, atol=1e-7)


def _edge_inputs(P, n, device):
    """K3/K4 inputs of B=3 chains with random positive E: chain 0 has
    is_last inside the chunk and an all-zero E column before it (the
    state turns uniform there), chain 1 ends in padding after its
    is_last, chain 2 is all padding (E = 0, as bucketed_state_emissions
    leaves a column without alleles)."""
    B = 3
    rng = np.random.default_rng(1000 * P + n)

    def rand(*shape):
        return torch.from_numpy(rng.random(shape).astype(np.float32))

    E, alpha0, beta0, e_after = rand(B, n, P, P), rand(B, P, P), rand(B, P, P), rand(B, P, P)
    u = fb_generic.factor_trans(rand(B, n, 3) * 0.1).contiguous()
    u_after = rand(B, 3) * 0.1
    is_last = torch.zeros((B, n), dtype=torch.bool)
    if n > 2:
        is_last[0, n // 2] = True
        E[0, n // 3] = 0.0
        tail = 2 * n // 3
        is_last[1, tail - 1] = True
        E[1, tail:] = 0.0
    else:
        is_last[1, n - 1] = True
    E[2] = 0.0
    to = [x.to(device) for x in (E, u, alpha0, e_after, u_after, is_last, beta0)]
    return tuple(to)


def _tiny_columns(x, b, lo):
    """Emissions x (K2's [B, N, A, A] or K3/K4's [B, n, P, P]) of columns
    lo and lo + 1 of chain b scaled by 1e-25, as real columns have them
    (emissions near 1e-41, totals of cur near 1e-20): a backward whose
    helper multiplies E by the unnormalized cur (1e-25 x 1e-25) underflows
    float32 there, the plain version's beta * E does not."""
    x = x.clone()
    x[b, lo:lo + 2] *= 1e-25
    return x


def _kept_columns_close(got, want):
    """Raw posteriors [B, N, X, X] on the columns whose plain sums float32
    keeps (above 1e-30): sums equal at rtol, columns divided by their sums
    at rtol/atol."""
    s_got = got.sum(dim=(-2, -1), keepdim=True)
    s_want = want.sum(dim=(-2, -1), keepdim=True)
    keep = (s_want > 1e-30).flatten(0, 1)[:, 0, 0]
    got, want = (got / s_got).flatten(0, 1), (want / s_want).flatten(0, 1)
    torch.testing.assert_close(s_got.flatten(0, 1)[keep], s_want.flatten(0, 1)[keep],
                               rtol=2e-4, atol=0)
    torch.testing.assert_close(got[keep], want[keep], rtol=2e-4, atol=1e-7)


def _posteriors_close_or_zero(got, want):
    """Columns whose plain posteriors are exactly 0 (their cur is 0: the
    column before an all-zero E column, and padding) are 0 in the
    kernel's too; the others as in :func:`_assert_posteriors_close`."""
    zero = want.sum(dim=(-2, -1)) == 0
    assert torch.equal(got[zero], want[zero])
    _assert_posteriors_close(got[~zero][None], want[~zero][None])


@pytest.mark.parametrize("n", [1, 37])
@pytest.mark.parametrize("P", [1, 31, 32, 33, 89, 96, 127, 128])
def test_generic_kernels_edge_columns(cuda, P, n):
    """K3/K4 against their plain versions at path counts on both sides
    of their warp and lane boundaries (n = 1, is_last inside the chunk,
    all-zero E columns, an all-padding chain), and two launches of each
    give the same bits."""
    E, u, alpha0, e_after, u_after, is_last, beta0 = _edge_inputs(P, n, cuda)
    launches = _generic_launches()
    a_k, c_k = fb_kernels.forward_e(E, u, alpha0)
    a_p, c_p = fb_generic.forward_e_plain(E, u, alpha0)
    torch.testing.assert_close(a_k, a_p, rtol=2e-4, atol=1e-7)
    torch.testing.assert_close(c_k, c_p, rtol=2e-4, atol=1e-7)
    args = (a_k, c_k, E, u, e_after, u_after, is_last, beta0)
    p_k, b_k = fb_kernels.backward_e(*args)
    p_p, b_p = fb_generic.backward_e_plain(*args)
    _posteriors_close_or_zero(p_k, p_p)
    torch.testing.assert_close(b_k, b_p, rtol=2e-4, atol=1e-7)
    a_2, c_2 = fb_kernels.forward_e(E, u, alpha0)
    p_2, b_2 = fb_kernels.backward_e(*args)
    torch.cuda.synchronize()
    assert torch.equal(a_2, a_k) and torch.equal(c_2, c_k)
    assert torch.equal(p_2, p_k) and torch.equal(b_2, b_k)
    k3, k4 = _generic_launches()
    assert (k3 - launches[0], k4 - launches[1]) == (2, 2)


def test_generic_kernels_reject_float64(cuda):
    E = torch.ones((1, 4, 8, 8), dtype=torch.float64, device=cuda)
    u = torch.zeros((1, 4, 3), dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        fb_kernels.forward_e(E, u, torch.ones((1, 8, 8), dtype=torch.float64, device=cuda))


def test_fused_kernels_reject_more_than_128_paths(cuda):
    """K1/K2 keep their limit (batch.use_generic sends such batches to
    K3/K4); the error names the route."""
    B, N, P, A = 1, 4, 129, 2
    ea = torch.ones((B, N, A, A), device=cuda)
    al = torch.zeros((B, N, P), dtype=torch.int32, device=cuda)
    trans = torch.zeros((B, N, 3), device=cuda)
    with pytest.raises(ValueError, match="generic route"):
        fb_kernels.forward(ea, al, trans)
    with pytest.raises(ValueError, match="generic route"):
        fb_kernels.backward(torch.ones((B, N, P, P), device=cuda),
                            torch.ones((B, N), device=cuda), ea, al, trans,
                            torch.zeros((B, N), dtype=torch.bool, device=cuda))


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("P", [129, 200, 256, 465, 471, 472, 600, 1025, 2049])
def test_wide_generic_kernels_match_plain(cuda, P, B):
    """K3/K4 past 128 paths (the cluster tier up to 471, the grid tier
    beyond: its state in registers at 472-1025, in shared memory at 2049
    for B=1) against their plain versions on the edge inputs (entry
    carries, is_last inside the chunk, an all-zero E column, padding; B =
    1 keeps the first chain), and two launches give the same bits."""
    inputs = _edge_inputs(P, 7, cuda)
    E, u, alpha0, e_after, u_after, is_last, beta0 = (x[:B].contiguous() for x in inputs)
    launches = _generic_launches()
    a_k, c_k = fb_kernels.forward_e(E, u, alpha0)
    a_p, c_p = fb_generic.forward_e_plain(E, u, alpha0)
    torch.testing.assert_close(a_k, a_p, rtol=2e-4, atol=1e-7)
    torch.testing.assert_close(c_k, c_p, rtol=2e-4, atol=1e-7)
    args = (a_k, c_k, E, u, e_after, u_after, is_last, beta0)
    p_k, b_k = fb_kernels.backward_e(*args)
    p_p, b_p = fb_generic.backward_e_plain(*args)
    _posteriors_close_or_zero(p_k, p_p)
    torch.testing.assert_close(b_k, b_p, rtol=2e-4, atol=1e-7)
    a_2, c_2 = fb_kernels.forward_e(E, u, alpha0)
    p_2, b_2 = fb_kernels.backward_e(*args)
    torch.cuda.synchronize()
    assert torch.equal(a_2, a_k) and torch.equal(c_2, c_k)
    assert torch.equal(p_2, p_k) and torch.equal(b_2, b_k)
    k3, k4 = _generic_launches()
    assert (k3 - launches[0], k4 - launches[1]) == (2, 2)


def _kernel_names(fn):
    """The names of the CUDA kernels fn() launches (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key for e in prof.key_averages()}


def test_200_paths_launch_the_cluster_kernels(cuda):
    """At P=200, the paths of ``genotype -a 200``'s chunks, K3/K4 launch
    their cluster-tier kernels (clusters of 16 CTAs, which the card holds
    at once for B=3) and not the one-CTA wide tier."""
    E, u, alpha0, e_after, u_after, is_last, beta0 = _edge_inputs(200, 7, cuda)
    assert fb_kernels.generic_launch(200, 3)[0] == 16
    for backward in (False, True):
        assert fb_kernels.cluster_fits(200, 3, backward) >= 3

    def both():
        a, c = fb_kernels.forward_e(E, u, alpha0)
        fb_kernels.backward_e(a, c, E, u, e_after, u_after, is_last, beta0)

    names = _kernel_names(both)
    for kernel in ("fbe_forward_cluster_kernel", "fbe_backward_cluster_kernel"):
        assert any(kernel in name for name in names), names
    assert not any("grid_kernel" in name for name in names), names


def test_600_paths_launch_the_grid_kernels(cuda):
    """At the chunk shape of ``genotype -f -a 600`` (B=2, P=600) K3/K4
    launch their grid-tier kernels (66 CTAs a chain on an H100, the
    state in registers, two hops) and neither the cluster tier nor the
    one-CTA wide tier that came before it; TIER_LAUNCHES counts them."""
    E, u, alpha0, e_after, u_after, is_last, beta0 = (
        x[:2].contiguous() for x in _edge_inputs(600, 7, cuda))
    grid = fb_kernels.grid_layout(600, 2, fb_kernels.grid_capacity())
    assert grid.ctas == fb_kernels.grid_capacity() // 2 > 1
    assert fb_kernels.generic_launch(600, 2)[0] == grid.ctas
    launches = dict(fb_kernels.TIER_LAUNCHES)

    def both():
        a, c = fb_kernels.forward_e(E, u, alpha0)
        fb_kernels.backward_e(a, c, E, u, e_after, u_after, is_last, beta0)

    names = _kernel_names(both)
    for kernel in ("fbe_forward_grid_kernel", "fbe_backward_grid_kernel"):
        assert any(kernel in name for name in names), names
    assert not any("wide_kernel" in name or "cluster_kernel" in name for name in names), names
    for k in ("K3", "K4"):
        assert fb_kernels.TIER_LAUNCHES[(k, "grid")] == launches[(k, "grid")] + 1


@pytest.mark.parametrize("P,sms,one_hop", [(600, 1, None), (600, 8, None), (1025, 16, None),
                                           (1025, 16, 0)])
def test_grid_sizes(cuda, monkeypatch, P, sms, one_hop):
    """The grid tier of the source built with FBE_GRID_SMS = sms (and
    FBE_GRID_ONE_HOP), as tools/fbe_times.py builds it: one CTA a chain
    (no arrivals, the state in global memory), 8 CTAs (shared memory),
    16 CTAs of one hop and of two, against the plain versions on the edge
    inputs, and the same bits twice."""
    defines = {"FBE_GRID_SMS": sms}
    monkeypatch.setattr(fb_kernels, "GRID_SMS", sms)
    if one_hop is not None:
        defines["FBE_GRID_ONE_HOP"] = one_hop
        monkeypatch.setattr(fb_kernels, "GRID_ONE_HOP", one_hop)
    monkeypatch.setattr(fb_kernels, "K3", _build.CudaKernel(
        "fb", "pg_fbe_forward", "fb", fb_kernels.K3._argtypes, defines=defines))
    monkeypatch.setattr(fb_kernels, "K4", _build.CudaKernel(
        "fb", "pg_fbe_backward", "fb", fb_kernels.K4._argtypes, defines=defines))
    assert fb_kernels.generic_launch(P, 1)[0] == min(sms, P)
    E, u, alpha0, e_after, u_after, is_last, beta0 = (
        x[:1].contiguous() for x in _edge_inputs(P, 9, cuda))
    a_k, c_k = fb_kernels.forward_e(E, u, alpha0)
    a_p, c_p = fb_generic.forward_e_plain(E, u, alpha0)
    torch.testing.assert_close(a_k, a_p, rtol=2e-4, atol=1e-7)
    torch.testing.assert_close(c_k, c_p, rtol=2e-4, atol=1e-7)
    args = (a_k, c_k, E, u, e_after, u_after, is_last, beta0)
    p_k, b_k = fb_kernels.backward_e(*args)
    p_p, b_p = fb_generic.backward_e_plain(*args)
    _posteriors_close_or_zero(p_k, p_p)
    torch.testing.assert_close(b_k, b_p, rtol=2e-4, atol=1e-7)
    assert torch.equal(fb_kernels.forward_e(E, u, alpha0)[0], a_k)
    assert torch.equal(fb_kernels.backward_e(*args)[0], p_k)


@pytest.mark.parametrize("P,ranks", [(200, 4), (129, 8), (200, 8)])
def test_generic_cluster_sizes(cuda, monkeypatch, P, ranks):
    """The clusters of the source built with FBE_CLUSTER_RANKS = ranks,
    as tools/fbe_times.py --ranks times them (4 CTAs of 2 rows a warp,
    8 CTAs of uneven bands), against the plain versions on the edge
    inputs, and the same bits twice."""
    monkeypatch.setattr(fb_kernels, "CLUSTER_RANKS", ranks)
    defines = {"FBE_CLUSTER_RANKS": ranks}
    monkeypatch.setattr(fb_kernels, "K3", _build.CudaKernel(
        "fb", "pg_fbe_forward", "fb", fb_kernels.K3._argtypes, defines=defines))
    monkeypatch.setattr(fb_kernels, "K4", _build.CudaKernel(
        "fb", "pg_fbe_backward", "fb", fb_kernels.K4._argtypes, defines=defines))
    assert fb_kernels.generic_launch(P, 3)[0] == ranks
    E, u, alpha0, e_after, u_after, is_last, beta0 = _edge_inputs(P, 9, cuda)
    a_k, c_k = fb_kernels.forward_e(E, u, alpha0)
    a_p, c_p = fb_generic.forward_e_plain(E, u, alpha0)
    torch.testing.assert_close(a_k, a_p, rtol=2e-4, atol=1e-7)
    torch.testing.assert_close(c_k, c_p, rtol=2e-4, atol=1e-7)
    args = (a_k, c_k, E, u, e_after, u_after, is_last, beta0)
    p_k, b_k = fb_kernels.backward_e(*args)
    p_p, b_p = fb_generic.backward_e_plain(*args)
    _posteriors_close_or_zero(p_k, p_p)
    torch.testing.assert_close(b_k, b_p, rtol=2e-4, atol=1e-7)
    assert torch.equal(fb_kernels.forward_e(E, u, alpha0)[0], a_k)
    assert torch.equal(fb_kernels.backward_e(*args)[0], p_k)
    assert (fb_kernels.K3.launches, fb_kernels.K4.launches) == (2, 2)


def test_route_takes_200_paths_on_the_card(cuda):
    """What ``genotype -a 200`` hands the forward-backward: a batch of 200
    paths goes to the generic route on the card (cuda_generic, K3/K4's
    cluster tier) without raising, and agrees with the same route on the
    CPU."""
    from pangenie_tpu_torch.hmm import batch

    B, N, P = 2, 40, 200
    launches = _generic_launches()
    posts, corr = batch.forward_backward_batch(_generic_columns(B, N, P, cuda))
    torch.cuda.synchronize()
    assert batch.last_dispatch == "cuda_generic"
    assert _generic_launches() != launches
    ref_p, ref_c = batch.forward_backward_batch(_generic_columns(B, N, P, "cpu"))
    assert batch.last_dispatch == "torch_generic"
    _assert_posteriors_close(posts.cpu(), ref_p)
    torch.testing.assert_close(corr.cpu(), ref_c, rtol=2e-4, atol=1e-7)


def _k2_inputs(B, N, P, A, seed):
    """K2's inputs in float32 on the CPU: emissions in [0.1, 1), alleles
    drawn per path, transitions from a recombination rate per column,
    is_last at the end of every chain and inside chain 0, and an all-zero
    emission column in chain 1 (forward and backward turn uniform there);
    alphas and c_fwd from the plain forward."""
    rng = np.random.default_rng(seed)
    ea = torch.from_numpy((0.1 + 0.9 * rng.random((B, N, A, A))).astype(np.float32))
    al = torch.from_numpy(rng.integers(0, A, (B, N, P)))
    r = rng.uniform(1e-3, 0.1, (B, N))
    switch = r / P
    stay = 1.0 - r + switch
    trans = torch.from_numpy(np.stack(
        [stay * stay, stay * switch, switch * switch], axis=-1).astype(np.float32))
    is_last = torch.zeros((B, N), dtype=torch.bool)
    is_last[:, N - 1] = True
    is_last[0, N // 2] = True
    if B > 1:
        ea[1, N // 3] = 0.0
    alphas, c_fwd = forward_plain(ea, al, trans)
    return alphas, c_fwd, ea, al, trans, is_last


@pytest.mark.parametrize("A", [2, 8])
@pytest.mark.parametrize("P", range(1, 33))
def test_k2_one_warp_tier_matches_plain(cuda, P, A):
    """K2's one-warp tier (P <= 32) against backward_plain on B=3 chains
    of 50 columns (more than its ring), is_last inside a chain and an
    all-zero emission column; two launches give the same bits."""
    inputs = tuple(x.to(cuda) for x in _k2_inputs(3, 50, P, A, seed=100 * P + A))
    launches = fb_kernels.K2.launches
    got = fb_kernels.backward(*inputs)
    again = fb_kernels.backward(*inputs)
    torch.cuda.synchronize()
    assert fb_kernels.K2.launches == launches + 2
    torch.testing.assert_close(got, backward_plain(*inputs), rtol=2e-4, atol=1e-7)
    assert torch.equal(again, got)


@pytest.mark.parametrize("P,A", [(16, 2), (16, 8), (32, 2), (33, 8)])
def test_k2_after_tiny_emissions(cuda, P, A):
    """K2 where two columns' emissions are near 1e-25 (_tiny_columns), on
    both tiers, against backward_plain (columns divided by their sums)."""
    alphas, c_fwd, ea, al, trans, is_last = _k2_inputs(3, 50, P, A, seed=7 * P + A)
    ea = _tiny_columns(ea, 1, 30)
    alphas, c_fwd = forward_plain(ea, al, trans)
    inputs = tuple(x.to(cuda) for x in (alphas, c_fwd, ea, al, trans, is_last))
    _kept_columns_close(fb_kernels.backward(*inputs).cpu(),
                        backward_plain(*inputs).cpu())


@pytest.mark.parametrize("P", [16, 89, 200, 600])
def test_generic_kernels_after_tiny_emissions(cuda, P):
    """K4 (register tiers, the cluster tier and the grid tier) where two
    columns' emissions are near 1e-25 (_tiny_columns), against its plain
    version on K3's alphas (columns divided by their sums)."""
    E, u, alpha0, e_after, u_after, is_last, beta0 = _edge_inputs(P, 37, cuda)
    E = _tiny_columns(E, 0, 5)
    a, c = fb_kernels.forward_e(E, u, alpha0)
    args = (a, c, E, u, e_after, u_after, is_last, beta0)
    p_k, b_k = fb_kernels.backward_e(*args)
    p_p, b_p = fb_generic.backward_e_plain(*args)
    _kept_columns_close(p_k.cpu(), p_p.cpu())
    torch.testing.assert_close(b_k, b_p, rtol=2e-4, atol=1e-7)


def test_k2_at_a_long_chain(cuda):
    """K2 at B=2 N=4096 P=16 A=2 (the bench's P and A) against the plain
    version."""
    cols = synthetic_columns(n_columns=4096, n_paths=16, n_kmers=16, n_alleles=2,
                             batch_dims=(2,), seed=11, dtype=np.float32)
    cols = columns_from_numpy(cols, cuda, torch.float32)
    ea = allele_emissions(cols)
    a, c = fb_kernels.forward(ea, cols.allele_local, cols.trans)
    p = fb_kernels.backward(a, c, ea, cols.allele_local, cols.trans, cols.is_last)
    p_ref = backward_plain(a, c, ea, cols.allele_local, cols.trans, cols.is_last)
    torch.testing.assert_close(p, p_ref, rtol=2e-4, atol=1e-7)


def _same_bits(got, want):
    """Two tuples of float32 tensors hold the same bits (-0 is not 0)."""
    return all(torch.equal(g.view(torch.int32), w.view(torch.int32))
               for g, w in zip(got, want))


def _cta_bits(ea, al, trans, got):
    """K1's outputs ``got`` are those of its 256-thread kernel (K1_CTA, at
    any P) on the same inputs, bit for bit; the comparison launch is not
    counted as K1's."""
    launches = fb_kernels.K1.launches
    assert _same_bits(got, fb_kernels.forward(ea, al, trans, fb_kernels.K1_CTA))
    assert fb_kernels.K1.launches == launches


@pytest.mark.parametrize("A", [2, 8])
@pytest.mark.parametrize("P", range(1, 33))
def test_k1_one_warp_tier_matches_plain(cuda, P, A):
    """K1's one-warp tier (P <= 32) against forward_plain on B=3 chains
    of 50 columns (more than its ring), with an all-zero emission column
    (uniform alphas, c_fwd 1); two launches give the same bits, those of
    the 256-thread kernel."""
    _alphas, _c, ea, al, trans, _last = (
        x.to(cuda) for x in _k2_inputs(3, 50, P, A, seed=100 * P + A))
    launches = fb_kernels.K1.launches
    got = fb_kernels.forward(ea, al, trans)
    again = fb_kernels.forward(ea, al, trans)
    torch.cuda.synchronize()
    assert fb_kernels.K1.launches == launches + 2
    for g, w in zip(got, forward_plain(ea, al, trans)):
        torch.testing.assert_close(g, w, rtol=2e-4, atol=1e-7)
    assert _same_bits(again, got)
    _cta_bits(ea, al, trans, got)


@pytest.mark.parametrize("further", [1.0, 1e-16])
@pytest.mark.parametrize("P,A", [(16, 2), (16, 8), (32, 2), (33, 8)])
def test_k1_after_tiny_emissions(cuda, P, A, further):
    """K1 where two columns' emissions are near 1e-25 (_tiny_columns), or
    1e-16 times that (subnormal: the total of cur is near 5e-42, whose
    reciprocal overflows float32), on both tiers, against forward_plain."""
    _alphas, _c, ea, al, trans, _last = _k2_inputs(3, 50, P, A, seed=7 * P + A)
    ea = _tiny_columns(ea, 1, 30)
    ea[1, 30:32] *= further
    ea, al, trans = ea.to(cuda), al.to(cuda), trans.to(cuda)
    got = fb_kernels.forward(ea, al, trans)
    assert bool(torch.isfinite(got[0]).all())
    for g, w in zip(got, forward_plain(ea, al, trans)):
        torch.testing.assert_close(g, w, rtol=2e-4, atol=1e-7)
    _cta_bits(ea, al, trans, got)


def test_k1_at_a_long_chain(cuda):
    """K1 at B=2 N=65,536 P=16 A=2 (the bench's B, N and P) against the
    plain version, with the 256-thread kernel's bits."""
    cols = synthetic_columns(n_columns=65536, n_paths=16, n_kmers=16, n_alleles=2,
                             batch_dims=(2,), seed=11, dtype=np.float32)
    cols = columns_from_numpy(cols, cuda, torch.float32)
    ea = allele_emissions(cols)
    got = fb_kernels.forward(ea, cols.allele_local, cols.trans)
    for g, w in zip(got, forward_plain(ea, cols.allele_local, cols.trans)):
        torch.testing.assert_close(g, w, rtol=2e-4, atol=1e-7)
    _cta_bits(ea, cols.allele_local, cols.trans, got)


@pytest.mark.parametrize("P,A", [(16, 4), (13, 4), (24, 3), (32, 2)])
def test_k1_one_warp_tier_gives_the_cta_bits_on_subnormal_cells(cuda, P, A):
    """K1's one-warp tier on B=2 chains of 4096 columns whose emissions,
    divided by their column's largest, are scaled by 1e-41 for unequal
    allele pairs: subnormal emissions, so subnormal cells of cur, as on
    real columns (where the float division takes its slow path and rounds
    most delicately), and some subnormal alphas: bit for bit the
    256-thread kernel's outputs, at the bench's P and A, where the cells
    are staged (P=13) and at Q = 32."""
    cols = synthetic_columns(n_columns=4096, n_paths=P, n_kmers=16, n_alleles=A,
                             batch_dims=(2,), seed=P + A, dtype=np.float32)
    cols = columns_from_numpy(cols, cuda, torch.float32)
    ea = allele_emissions(cols)
    ea = ea / ea.amax((-1, -2), keepdim=True)
    same = torch.eye(A, dtype=torch.bool, device=cuda)
    ea = torch.where(same, ea, ea * 1e-41).contiguous()
    tiny = torch.finfo(torch.float32).tiny
    assert int(((ea != 0) & (ea < tiny)).sum()) > 0
    got = fb_kernels.forward(ea, cols.allele_local, cols.trans)
    _cta_bits(ea, cols.allele_local, cols.trans, got)


def _v1_inputs(seed, B, N, P, A, ties=False, uniform=False, pad_from=None, device="cpu"):
    """Float32 inputs of kernel V1 for B chains: log emissions (from a
    small set of values with ``ties``, else continuous, some -inf),
    alleles with a duplicated path, every chain's column 1 of zero
    emissions (all -inf), log transitions with stay >= switch one >=
    switch both (zeros with ``uniform``); chain b > 0 padded from column
    pad_from[b - 1] on as PairHMM pads a bucket (emissions 0, allele
    0, lt (0, -inf, -inf))."""
    rng = np.random.default_rng(seed)
    if ties:
        logea = rng.choice([0.0, -1.0, -2.0], size=(B, N, A, A))
    else:
        logea = np.log(rng.random((B, N, A, A))) * 4.0
        logea[rng.random((B, N, A, A)) < 0.05] = -np.inf
    logea = np.minimum(logea, np.swapaxes(logea, 2, 3))   # symmetric, as emissions are
    al = rng.integers(0, A, size=(B, N, P))
    if P > 3:
        al[:, :, 3] = al[:, :, 2]
    if N > 2:
        logea[:, 1] = -np.inf
    switch = rng.random((B, N)) * 0.2
    trans = np.stack([(1 - switch) ** 2, (1 - switch) * switch, switch ** 2], axis=-1)
    if pad_from is not None:
        for b, lo in enumerate(pad_from, start=1):
            logea[b, lo:] = 0.0
            al[b, lo:] = 0
            trans[b, lo:] = (1.0, 0.0, 0.0)
    with np.errstate(divide="ignore"):
        lt = np.zeros_like(trans) if uniform else np.log(trans)
    return viterbi.Inputs(torch.from_numpy(logea.astype(np.float32)).to(device),
                          torch.from_numpy(al.astype(np.int32)).to(device),
                          torch.from_numpy(lt.astype(np.float32)).to(device))


def _v1_start(B, P, device="cpu"):
    return (torch.zeros((B, P * P), dtype=torch.float32, device=device),
            torch.ones((B,), dtype=torch.bool, device=device))


def _v1_matches_plain(inputs, carry, first):
    """V1 and its plain version on the same inputs on the card: the
    same states, state before the first column, backtraces and exit
    carry bits."""
    launches = v1_kernels.V1.launches
    got = v1_kernels.sweep(inputs, carry, first)
    torch.cuda.synchronize()
    assert v1_kernels.V1.launches == launches + 1
    want = viterbi.segment_plain(inputs, carry, first)
    assert torch.equal(got.states, want.states)
    assert torch.equal(got.state_out, want.state_out)
    assert torch.equal(got.bt.int(), want.bt)
    assert _same_bits(got.carry, want.carry)


@pytest.mark.parametrize("A", [2, 8])
@pytest.mark.parametrize("P", range(1, 33))
def test_v1_matches_plain(cuda, P, A):
    """Every P of V1's lane layouts, B=3 chains of 90 columns (past its
    ring), one padded from column 50."""
    inputs = _v1_inputs(P + A, 3, 90, P, A, pad_from=(90, 50), device=cuda)
    _v1_matches_plain(inputs, *_v1_start(3, P, cuda))


@pytest.mark.parametrize("P", [5, 16, 30])
def test_v1_ties_and_zero_columns(cuda, P):
    """Emissions from three values (ties everywhere) and all-zero
    columns, with and without ``uniform`` transitions."""
    for uniform in (False, True):
        inputs = _v1_inputs(P, 3, 200, P, 4, ties=True, uniform=uniform,
                            pad_from=(150, 9), device=cuda)
        _v1_matches_plain(inputs, *_v1_start(3, P, cuda))


def test_v1_at_a_long_chain(cuda):
    """A chain of 65,536 columns at P=30 (the phasing run's most paths)
    against the plain version, two launches bit-identical."""
    inputs = _v1_inputs(30, 1, 65536, 30, 8, device=cuda)
    carry, first = _v1_start(1, 30, cuda)
    _v1_matches_plain(inputs, carry, first)
    a = v1_kernels.sweep(inputs, carry, first)
    b = v1_kernels.sweep(inputs, carry, first)
    assert _same_bits(a.carry, b.carry) and torch.equal(a.bt, b.bt)
    assert torch.equal(a.states, b.states)


def test_v1_small_budget_equals_the_full_run(cuda):
    """``viterbi`` under a budget that holds only a few hundred columns
    of backtraces runs the checkpointed form (forward launches without
    backtraces, then each segment again) and gives the one launch's
    states."""
    cols = synthetic_columns(n_columns=3000, n_paths=30, n_kmers=8, n_alleles=4,
                             batch_dims=(2,), seed=5, dtype=np.float32)
    cols = columns_from_numpy(cols, cuda, torch.float32)
    launches = v1_kernels.V1.launches
    full = viterbi.viterbi(cols)
    assert v1_kernels.V1.launches == launches + 1
    budget = 2 * 1024 * 1024
    segment = viterbi.segment_columns(budget, 2, 3000, 30)
    assert segment < 3000
    got = viterbi.viterbi(cols, budget=budget)
    n_segs = -(-3000 // segment)
    assert v1_kernels.V1.launches == launches + 1 + 2 * n_segs - 1
    assert torch.equal(got, full)


def test_v1_refuses_what_it_does_not_take(cuda):
    inputs = _v1_inputs(1, 1, 4, 33, 2, device=cuda)
    with pytest.raises(ValueError, match="at most 32 paths"):
        v1_kernels.sweep(inputs, *_v1_start(1, 33, cuda))
    inputs = _v1_inputs(1, 1, 4, 8, 2, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        v1_kernels.sweep(inputs._replace(logea=inputs.logea.double()), *_v1_start(1, 8, cuda))


_PHASING_RUN = """
import json, sys
import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile
from pangenie_tpu_torch.commands import run_single_command
from pangenie_tpu_torch.hmm import v1_kernels
from pangenie_tpu_torch.utils import simulate as sim

d = sys.argv[1]
rng = np.random.default_rng(3)
reference = sim.random_reference(20_000, rng)
variants = sim.simulate_panel(reference, nr_samples=4, rng=rng)
sim.write_inputs(d, reference, variants)
hap1, hap2 = sim.haplotype_sequences(reference, variants, sample=0)
sim.simulate_reads(hap1, hap2, coverage=20, read_length=100, rng=rng, outfile=d + "/reads.fa")
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    run_single_command(d + "/reads.fa", d + "/ref.fa", d + "/panel.vcf", 31, d + "/out",
                       only_genotyping=False, device="cuda")
    torch.cuda.synchronize()
print(json.dumps({"names": sorted({e.key for e in prof.key_averages()}),
                  "launches": v1_kernels.V1.launches}))
"""


def test_phasing_launches_v1(cuda, tmp_path):
    """``single -g -p`` on the card launches V1 (by torch.profiler, in a
    process of its own) and writes the phasing VCF."""
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    proc = subprocess.run([sys.executable, "-c", _PHASING_RUN, str(tmp_path)], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["launches"] >= 1
    assert any("v1_viterbi_kernel" in name for name in out["names"]), out["names"]
    with open(tmp_path / "out_phasing.vcf") as f:
        assert sum(not line.startswith("#") for line in f) > 10


def _d1_block(seed, n_reads, length, device, n_rate=0.01):
    """n_reads reads of 1 - length bases (N at n_rate) as one flat block
    on ``device``: (words, vwords, bases, the reads)."""
    from pangenie_tpu_torch.kmers import device_counter as dc

    rng = np.random.default_rng(seed)
    p = [(1 - n_rate) / 4] * 4 + [n_rate]
    reads = [bytes(rng.choice(list(b"ACGTN"), int(n), p=p).astype(np.uint8))
             for n in rng.integers(1, length + 1, n_reads)]
    offsets = np.concatenate([[0], np.cumsum([len(r) for r in reads])])
    words, vwords, n_bases = dc.pack_sequences(np.frombuffer(b"".join(reads), np.uint8),
                                               offsets[:-1], np.diff(offsets))
    return dc._on(device, words), dc._on(device, vwords), n_bases, reads


@pytest.mark.parametrize("k", [1, 5, 11, 21, 31])
def test_d1_kernels_match_plain(cuda, k):
    """D1-extract's keys and D1-count's counts equal their plain
    versions on the same block, one launch each, and the keys the host
    engine's."""
    from pangenie_tpu_torch.kmers import device_counter as dc
    from pangenie_tpu_torch.kmers.counter import ExactKmerCounter

    words, vwords, n_bases, reads = _d1_block(k, 20_000, 160, cuda)
    launches = dc.D1_EXTRACT.launches, dc.D1_COUNT.launches
    keys = dc.extract(words, vwords, n_bases, k)
    torch.cuda.synchronize()
    assert torch.equal(keys, dc.extract_plain(words, vwords, n_bases, k))
    host = ExactKmerCounter._extract_canonical(reads, k)
    valid = keys[keys != dc.SENTINEL].cpu().numpy().view(np.uint64)
    assert np.array_equal(np.sort(valid), np.sort(host))
    table = dc.make_table(torch.unique(keys[keys != dc.SENTINEL])[::2].contiguous(), k)
    got = torch.zeros(table.keys.shape, dtype=torch.int32, device=cuda)
    want = torch.zeros_like(got)
    dc.count(words, vwords, n_bases, k, table, got)
    dc.count_plain(words, vwords, n_bases, k, table, want)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and got.sum() > 0
    assert (dc.D1_EXTRACT.launches, dc.D1_COUNT.launches) == (launches[0] + 1, launches[1] + 1)


@pytest.mark.parametrize("d", ["0", "16", "rule", "24"])
def test_d1_count_at_each_directory_size(cuda, d):
    """D1-count's counts equal the plain version's with the directory at
    0 bits (one bucket, narrowed by binary steps), 16, the rule's and 24,
    on a block whose table holds every other key."""
    from pangenie_tpu_torch.kmers import device_counter as dc

    words, vwords, n_bases, _ = _d1_block(9, 20_000, 160, cuda)
    keys = dc.extract(words, vwords, n_bases, 31)
    table = dc.make_table(torch.unique(keys[keys != dc.SENTINEL])[::2].contiguous(), 31,
                          None if d == "rule" else int(d))
    got = torch.zeros(table.keys.shape, dtype=torch.int32, device=cuda)
    want = torch.zeros_like(got)
    dc.count(words, vwords, n_bases, 31, table, got)
    dc.count_plain(words, vwords, n_bases, 31, table, want)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and got.sum() > 0


@pytest.mark.parametrize("n", [1, 2, 3])
def test_d1_count_into_tiny_tables(cuda, n):
    """Tables of 1-3 keys whose next int64 is a key the reads hold, with
    counts whose next int32 is watched: nothing is read past the table."""
    from pangenie_tpu_torch.kmers import device_counter as dc

    words, vwords, n_bases, _ = _d1_block(10, 2_000, 160, cuda)
    keys = dc.extract(words, vwords, n_bases, 31)
    present = torch.unique(keys[keys != dc.SENTINEL])
    held = torch.cat([present[:n], present[-1:]])
    counts = torch.zeros(n + 1, dtype=torch.int32, device=cuda)
    table = dc.make_table(held[:n], 31)
    dc.count(words, vwords, n_bases, 31, table, counts[:n])
    want = torch.zeros(n, dtype=torch.int32, device=cuda)
    dc.count_plain(words, vwords, n_bases, 31, table, want)
    torch.cuda.synchronize()
    assert torch.equal(counts[:n], want) and counts[n].item() == 0


def test_d1_refuses_what_it_does_not_take(cuda):
    from pangenie_tpu_torch.kmers import device_counter as dc

    words, vwords, n_bases, _ = _d1_block(1, 10, 50, cuda)
    with pytest.raises(ValueError, match="int32"):
        dc.extract(words.long(), vwords, n_bases, 31)
    with pytest.raises(ValueError, match="k in"):
        dc.extract(words, vwords, n_bases, 32)
    table = dc.make_table(torch.arange(5, dtype=torch.int64, device=cuda), 31)
    with pytest.raises(ValueError, match="counts"):
        dc.count(words, vwords, n_bases, 31, table, torch.zeros(5, dtype=torch.int64,
                                                                device=cuda))


@pytest.mark.parametrize("given", [False, True], ids=["table_built", "keys_given"])
def test_d1_file_counter_equals_the_host_engine(cuda, tmp_path, given):
    """count_file_primed_device on the card (the table built there or
    given, blocks small enough for several launches) gives the host
    engine's keys and counts."""
    from pangenie_tpu_torch.kmers import device_counter as dc
    from pangenie_tpu_torch.kmers.counter import ExactKmerCounter

    rng = np.random.default_rng(5)
    genome = bytes(rng.choice(list(b"ACGT"), 50_000).astype(np.uint8))
    (tmp_path / "c.fa").write_text(f">g\n{genome.decode()}\n")
    with open(tmp_path / "r.fa", "w") as out:
        for i, s in enumerate(rng.integers(0, len(genome) - 150, 4000)):
            out.write(f">r{i}\n{genome[s:s + 150].decode()}\n")
    reads, corpus = str(tmp_path / "r.fa"), str(tmp_path / "c.fa")
    host = ExactKmerCounter.count_file_primed(reads, [corpus], 31)
    launches = dc.D1_COUNT.launches
    dev = dc.count_file_primed_device(reads, [corpus], 31, block_bases=1 << 16,
                                      keys=host.keys if given else None, device=cuda)
    assert np.array_equal(dev.keys, host.keys) and np.array_equal(dev.counts, host.counts)
    assert dc.D1_COUNT.launches - launches >= 8


@pytest.mark.parametrize("k, d", [(1, "rule"), (31, "0"), (31, "16"), (31, "rule")])
def test_d1_count_keys_matches_plain(cuda, k, d):
    """D1-count-keys on a block's keys as a partition receives them
    (SENTINEL, keys the table lacks, keys wider than 2k bits among them),
    with the directory at 0, 16 and the rule's d: the plain version's
    counts, one launch, the same counts as D1-count on the block; and an
    empty partition is left untouched."""
    from pangenie_tpu_torch.kmers import device_counter as dc

    words, vwords, n_bases, _ = _d1_block(20 + k, 20_000, 160, cuda)
    keys = dc.extract(words, vwords, n_bases, k)
    keys = torch.cat([keys, torch.tensor([4 ** k, -1], dtype=torch.int64, device=cuda)])
    table = dc.make_table(torch.unique(keys[(keys != dc.SENTINEL) & (keys >= 0)
                                            & (keys < 4 ** k)])[::2].contiguous(), k,
                          None if d == "rule" else int(d))
    got = torch.zeros(table.keys.shape, dtype=torch.int32, device=cuda)
    want = torch.zeros_like(got)
    from_block = torch.zeros_like(got)
    launches = dc.D1_COUNT_KEYS.launches
    dc.count_keys(keys, k, table, got)
    dc.count_keys_plain(keys, table, want)
    dc.count(words, vwords, n_bases, k, table, from_block)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(got, from_block) and got.sum() > 0
    assert dc.D1_COUNT_KEYS.launches == launches + 1
    empty = dc.make_table(torch.zeros(0, dtype=torch.int64, device=cuda), k)
    none = torch.zeros(0, dtype=torch.int32, device=cuda)
    dc.count_keys(keys, k, empty, none)
    torch.cuda.synchronize()
