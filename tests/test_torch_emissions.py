"""The port's batched emissions vs the reference package's
``jax.vmap(log_emission_allele_matrix)`` and ``emission_scale``, in
float64 on the same numpy inputs.

Tolerance rtol=1e-12: both sides sum the same terms, but XLA and torch
may order the k-mer sums and evaluate logaddexp differently in the last
ulp."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pangenie_tpu.hmm import emissions as jax_em
from pangenie_tpu_torch.hmm import emissions as torch_em

torch.set_num_threads(1)


def _inputs(seed, B=2, N=9, K=6, A=3, undefined=0.0, neg_inf=0.0,
            all_zeros=0.0, masked=0.0):
    rng = np.random.default_rng(seed)
    lp = np.log(rng.uniform(1e-6, 1.0, (B, N, K, 3)))
    lp[rng.random((B, N, K, 3)) < neg_inf] = -np.inf
    incidence = rng.random((B, N, K, A)) < 0.4
    kmer_mask = rng.random((B, N, K)) >= masked
    und = rng.random((B, N, A)) < undefined
    az = rng.random((B, N)) < all_zeros
    scale = rng.normal(size=(B, N))
    return lp, incidence, kmer_mask, und, az, scale


CASES = {
    "plain": {},
    "undefined_alleles": {"undefined": 0.4},
    "neg_inf_probabilities": {"neg_inf": 0.3},
    "all_zeros_columns": {"all_zeros": 0.5, "neg_inf": 0.2},
    "masked_kmers": {"masked": 0.5},
    "everything": {"undefined": 0.3, "neg_inf": 0.2, "all_zeros": 0.2,
                   "masked": 0.3},
    "biallelic_wide": {"A": 2, "K": 16, "undefined": 0.1},
}


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("seed", [0, 1])
def test_log_emission_allele_matrix_matches_jax(name, seed):
    args = _inputs(seed, **CASES[name])
    ref = jax.vmap(jax.vmap(jax_em.log_emission_allele_matrix))(
        *[jnp.asarray(a) for a in args]
    )
    got = torch_em.log_emission_allele_matrix(*[torch.from_numpy(a) for a in args])
    ref = np.asarray(ref)
    got = got.numpy()
    assert got.dtype == np.float64 and got.shape == ref.shape
    # -inf entries must sit at the same places
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-12, atol=0)


def test_log_emission_chunks_cover_every_column(monkeypatch):
    """Column chunking (bounded temporaries) gives the unchunked result."""
    args = [torch.from_numpy(a) for a in _inputs(3, N=11, undefined=0.3)]
    whole = torch_em.log_emission_allele_matrix(*args)
    monkeypatch.setattr(torch_em, "_CHUNK_ELEMS", 1)
    chunked = torch_em.log_emission_allele_matrix(*args)
    assert torch.equal(whole, chunked)


@pytest.mark.parametrize("neg_inf,masked", [(0.0, 0.0), (0.4, 0.3), (1.0, 0.0)])
def test_emission_scale_matches_jax(neg_inf, masked):
    lp, _, kmer_mask, _, _, _ = _inputs(4, neg_inf=neg_inf, masked=masked)
    ref = np.asarray(jax_em.emission_scale(jnp.asarray(lp), jnp.asarray(kmer_mask)))
    got = torch_em.emission_scale(torch.from_numpy(lp), torch.from_numpy(kmer_mask))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12, atol=1e-300)
