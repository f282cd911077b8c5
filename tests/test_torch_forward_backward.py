"""The port's forward-backward (plain torch, the CPU path of
``forward_backward_batch``) vs the reference package, on the same numpy
inputs:

- vs ``jax.vmap(forward_backward)`` (the XLA scan) in float64,
  rtol=1e-10: same recurrence, sums taken in another order;
- vs ``pallas_fb.forward_backward_batch_pallas(interpret=True)`` (the
  TPU kernels K1/K2) in float32 with the reference package's own
  kernel-vs-scan tolerance, rtol=2e-4, atol=1e-7
  (tests/test_pallas_fb.py).

Shapes follow tests/test_pallas_fb.py: B not a power of two, padded
tail columns after is_last, multiallelic A=3, all-zero columns.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pangenie_tpu.hmm.forward_backward import forward_backward as jax_fb
from pangenie_tpu.hmm.pallas_fb import forward_backward_batch_pallas
from pangenie_tpu.utils.synthetic import synthetic_columns
from pangenie_tpu_torch.hmm import batch, fb_kernels
from pangenie_tpu_torch.hmm.forward_backward import (
    allele_emissions,
    backward_plain,
    columns_from_numpy,
    forward_plain,
)

torch.set_num_threads(1)


def _padded_tail(cols):
    is_last = np.zeros_like(np.asarray(cols.is_last))
    is_last[..., 7] = True
    return cols._replace(is_last=is_last)


def _all_zero_column(cols):
    lp = np.asarray(cols.lp).copy()
    lp[:, 2] = -np.inf        # column 2: all kmer probabilities zero
    az = np.asarray(cols.all_zeros).copy()
    az[:, 2] = True
    return cols._replace(lp=lp, all_zeros=az)


CASES = {
    "b3_n24_p8_k8": (dict(n_columns=24, n_paths=8, n_kmers=8, batch_dims=(3,)), None),
    "b2_n17_p16_k4": (dict(n_columns=17, n_paths=16, n_kmers=4, batch_dims=(2,)), None),
    "multiallelic_a3": (dict(n_columns=10, n_paths=8, n_kmers=6, n_alleles=3,
                             batch_dims=(2,)), None),
    "padded_tail": (dict(n_columns=12, n_paths=8, n_kmers=4, batch_dims=(2,)),
                    _padded_tail),
    "all_zero_column": (dict(n_columns=6, n_paths=4, n_kmers=4, batch_dims=(1,)),
                        _all_zero_column),
}


def _columns(name, dtype):
    kw, edit = CASES[name]
    cols = synthetic_columns(dtype=dtype, seed=11, **kw)
    return edit(cols) if edit else cols


def _port(cols, dtype):
    out = batch.forward_backward_batch(
        columns_from_numpy(cols, torch.device("cpu"), dtype)
    )
    assert batch.last_dispatch == "torch_ref"
    return [x.numpy() for x in out]


def _real(name, x):
    """Padded-tail columns after is_last carry no result."""
    return x[:, :8] if name == "padded_tail" else x


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_xla_scan_float64(name):
    cols = _columns(name, np.float64)
    ref_p, ref_c = jax.jit(jax.vmap(jax_fb))(
        type(cols)(*[jnp.asarray(np.asarray(x)) for x in cols])
    )
    got_p, got_c = _port(cols, torch.float64)
    assert got_p.dtype == np.float64
    np.testing.assert_allclose(_real(name, got_p), _real(name, np.asarray(ref_p)),
                               rtol=1e-10, atol=1e-300)
    np.testing.assert_allclose(got_c, np.asarray(ref_c), rtol=1e-12)


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_pallas_kernels_float32(name):
    cols = _columns(name, np.float32)
    ref_p, ref_c = forward_backward_batch_pallas(
        type(cols)(*[jnp.asarray(np.asarray(x)) for x in cols]), interpret=True
    )
    got_p, got_c = _port(cols, torch.float32)
    assert got_p.dtype == np.float32
    np.testing.assert_allclose(_real(name, got_p), _real(name, np.asarray(ref_p)),
                               rtol=2e-4, atol=1e-7)
    np.testing.assert_allclose(got_c, np.asarray(ref_c), rtol=1e-6)


def test_kernel_wrappers_take_plain_version_on_cpu():
    """On CPU tensors the K1/K2 wrappers run the plain version and
    launch nothing."""
    cols = columns_from_numpy(_columns("multiallelic_a3", np.float32),
                              torch.device("cpu"), torch.float32)
    ea = allele_emissions(cols)
    before = (fb_kernels.K1.launches, fb_kernels.K2.launches)
    a, c = fb_kernels.forward(ea, cols.allele_local, cols.trans)
    a_ref, c_ref = forward_plain(ea, cols.allele_local, cols.trans)
    assert torch.equal(a, a_ref) and torch.equal(c, c_ref)
    p = fb_kernels.backward(a, c, ea, cols.allele_local, cols.trans, cols.is_last)
    p_ref = backward_plain(a, c, ea, cols.allele_local, cols.trans, cols.is_last)
    assert torch.equal(p, p_ref)
    assert (fb_kernels.K1.launches, fb_kernels.K2.launches) == before


def test_columns_from_numpy_dtypes():
    cols = columns_from_numpy(_columns("b3_n24_p8_k8", np.float64),
                              torch.device("cpu"), torch.float32)
    assert cols.lp.dtype == cols.scale.dtype == cols.trans.dtype == torch.float32
    assert cols.allele_local.dtype == torch.int64
    assert cols.is_last.dtype == torch.bool
