"""Kernels K1-K4 (csrc/fb.cu) and S1 (csrc/sampling_dp.cu) against
their plain torch versions, on the card.

Marked ``cuda``: a CUDA kernel has no interpret mode, so these skip
where there is no GPU. Run them on a GPU machine with
``python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py``
(the GPU machine has no JAX, which tests/conftest.py imports).
"""

import numpy as np
import pytest
import torch

from pangenie_tpu_torch.hmm import fb_generic, fb_kernels, sampling
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


@pytest.mark.parametrize("C,N,P,masked", [(1, 50, 5, 0.0), (3, 200, 123, 0.3),
                                          (2, 64, 1, 0.2), (2, 40, 33, 0.97)])
def test_s1_matches_plain(cuda, C, N, P, masked):
    rng = np.random.default_rng(P)
    cost = torch.from_numpy(rng.integers(0, 4, (C, N, P)).astype(np.int32)).to(cuda)
    mask = torch.from_numpy(rng.random((C, N, P)) >= masked).to(cuda)
    switch = torch.from_numpy(rng.integers(0, 6, (C, N)).astype(np.int32)).to(cuda)
    paths, scores = sampling.viterbi_iteration(cost, mask, switch)
    torch.cuda.synchronize()
    ref_paths, ref_scores = sampling.viterbi_iteration_plain(cost, mask, switch)
    assert torch.equal(paths, ref_paths)
    assert torch.equal(scores, ref_scores)


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


def test_generic_kernels_reject_more_than_128_paths(cuda):
    P = 129
    E = torch.ones((1, 4, P, P), device=cuda)
    with pytest.raises(ValueError, match="paths exceed"):
        fb_kernels.forward_e(E, torch.zeros((1, 4, 3), device=cuda),
                             torch.ones((1, P, P), device=cuda))
    with pytest.raises(ValueError, match="paths exceed"):
        fb_kernels.backward_e(
            E, torch.ones((1, 4), device=cuda), E, torch.zeros((1, 4, 3), device=cuda),
            E[:, 0], torch.zeros((1, 3), device=cuda),
            torch.zeros((1, 4), dtype=torch.bool, device=cuda), E[:, 0])
