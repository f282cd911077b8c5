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
