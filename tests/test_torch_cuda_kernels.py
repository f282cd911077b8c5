"""Kernels K1/K2 (csrc/fb.cu) and S1 (csrc/sampling_dp.cu) against
their plain torch versions, on the card.

Marked ``cuda``: a CUDA kernel has no interpret mode, so these skip
where there is no GPU. Run them on a GPU machine with
``python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py``
(the GPU machine has no JAX, which tests/conftest.py imports).
"""

import numpy as np
import pytest
import torch

from pangenie_tpu_torch.hmm import fb_kernels, sampling
from pangenie_tpu_torch.hmm.forward_backward import (
    allele_emissions,
    backward_plain,
    columns_from_numpy,
    forward_plain,
)
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
