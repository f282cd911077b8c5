"""The port's any-A chunked forward-backward (``hmm/fb_generic.py``,
plain versions of kernels K3/K4) vs the reference package's generic
Pallas path (``pangenie_tpu/hmm/pallas_fb.py``, kernels run in
interpret mode) and its XLA scan, on the same numpy inputs.

Tolerances: float32 rtol=2e-4 / atol=1e-7, the one the reference uses
between its Pallas kernels and its scan (tests/test_pallas_fb.py);
float64 rtol=1e-12 (XLA and torch may order sums differently in the
last ulp). The A-bucketed emission expansion is held bit for bit: fed
the reference's own [A, A] emissions, the port's bucketing, gather
padding and [P, P] expansion give exactly the reference's E. The
emission math itself (exp of k-mer log sums) differs by an ulp between
XLA and torch (see tests/test_torch_emissions.py), so the port's E as a
whole is held at float64 rtol=1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pangenie_tpu.hmm import emissions as jax_em
from pangenie_tpu.hmm import pallas_fb
from pangenie_tpu.hmm.forward_backward import ColumnArrays as JaxColumnArrays
from pangenie_tpu.hmm.forward_backward import forward_backward
from pangenie_tpu_torch.hmm import batch, fb_generic
from pangenie_tpu_torch.hmm.forward_backward import (
    _state_emission,
    allele_emissions,
    columns_from_numpy,
)
from pangenie_tpu_torch.utils.multiallelic import allele_mix, multiallelic_columns
from test_pallas_fb_generic import _f32_device, _mixed_allele_columns

torch.set_num_threads(1)

RTOL32, ATOL32 = 2e-4, 1e-7


def _jax_cols(cols, dtype):
    if dtype == np.float32:
        return _f32_device(cols)
    return type(cols)(*[jnp.asarray(np.asarray(x)) for x in cols])


def _torch_cols(cols, dtype):
    return columns_from_numpy(cols, "cpu", {np.float32: torch.float32,
                                            np.float64: torch.float64}[dtype])


def _f64(cols):
    return cols._replace(**{k: np.asarray(getattr(cols, k)).astype(np.float64)
                            for k in ("lp", "scale", "trans")})


def _jax_bucket_emissions(lp, incidence, kmer_mask, undefined, all_zeros, scale):
    """The reference's per-bucket emission math on the port's inputs."""
    ea = jnp.exp(jax.vmap(jax_em.log_emission_allele_matrix)(
        *[jnp.asarray(x.numpy()) for x in
          (lp, incidence, kmer_mask, undefined, all_zeros, scale)]))
    return torch.from_numpy(np.array(ea))


@pytest.mark.parametrize("B,N,P,K,A_hi", [(2, 21, 6, 4, 5), (2, 40, 8, 6, 12),
                                          (3, 33, 16, 8, 16)])
def test_bucketed_emissions_bit_identical(monkeypatch, B, N, P, K, A_hi):
    cols = _mixed_allele_columns(B, N, P, K, A_hi=A_hi)
    ref = np.asarray(pallas_fb.bucketed_state_emissions(_f32_device(cols)))
    tc = _torch_cols(cols, np.float32)
    # the port's own full-A expansion, as the reference's test holds it
    ea = allele_emissions(tc).flatten(0, 1)
    full = _state_emission(ea, tc.allele_local.flatten(0, 1))
    assert torch.equal(fb_generic.bucketed_state_emissions(tc),
                       full.reshape(B, N, P * P))
    monkeypatch.setattr(fb_generic, "bucket_allele_emissions", _jax_bucket_emissions)
    got = fb_generic.bucketed_state_emissions(tc).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("A_hi", [5, 12])
def test_bucketed_emissions_match_in_float64(A_hi):
    cols = _f64(_mixed_allele_columns(2, 30, 8, 6, A_hi=A_hi, seed=4))
    ref = np.asarray(pallas_fb.bucketed_state_emissions(_jax_cols(cols, np.float64)))
    got = fb_generic.bucketed_state_emissions(_torch_cols(cols, np.float64)).numpy()
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got == 0, ref == 0)
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=0)


@pytest.mark.parametrize("A_hi", [3, 12])
def test_bucketed_collapse_matches(A_hi):
    cols = _f64(_mixed_allele_columns(2, 25, 7, 4, A_hi=A_hi, seed=5))
    B, N, P = np.asarray(cols.alleles).shape
    posts = np.random.default_rng(2).random((B, N, P, P))
    ref = np.asarray(pallas_fb.bucketed_collapse(
        jnp.asarray(posts.reshape(B, N, P * P)), _jax_cols(cols, np.float64)))
    got = fb_generic.bucketed_collapse(torch.from_numpy(posts),
                                       _torch_cols(cols, np.float64)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=0)


def test_bucketed_collapse_in_bounded_slices(monkeypatch):
    cols = _torch_cols(_f64(_mixed_allele_columns(2, 19, 5, 4, A_hi=6, seed=6)),
                       np.float64)
    posts = torch.from_numpy(np.random.default_rng(3).random((2, 19, 5, 5)))
    whole = fb_generic.bucketed_collapse(posts, cols)
    monkeypatch.setattr(fb_generic, "_COLLAPSE_ELEMS", 1)
    assert torch.equal(fb_generic.bucketed_collapse(posts, cols), whole)


# the last case is past 471 paths, where the port's K3/K4 run their grid
# tier on the card (about 10 s of interpret mode)
@pytest.mark.parametrize("B,N,P,K,A_hi", [(2, 23, 8, 6, 5), (1, 9, 4, 4, 3),
                                          (2, 30, 6, 4, 12), (1, 5, 480, 4, 3)])
def test_chunked_fb_matches_pallas_generic(B, N, P, K, A_hi):
    cols = _mixed_allele_columns(B, N, P, K, A_hi)
    ref_p, ref_c = pallas_fb.forward_backward_batch_pallas_e(
        _f32_device(cols), interpret=True)
    got_p, got_c = fb_generic.forward_backward_chunked(_torch_cols(cols, np.float32))
    assert fb_generic.last_walk == (B, N, 1)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(ref_p), rtol=RTOL32, atol=ATOL32)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(ref_c), rtol=RTOL32, atol=0)


@pytest.mark.parametrize("N,chunk", [(70, 16), (64, 32), (47, 16)])
def test_chunked_fb_matches_pallas_core(N, chunk):
    cols = _mixed_allele_columns(2, N, 6, 4, A_hi=4, seed=9)
    jc = _f32_device(cols)
    E = pallas_fb.bucketed_state_emissions(jc)
    posts, ref_c = pallas_fb._fb_pallas_e_core(
        E, jc.trans, jc.is_last, jc.scale, P=6, chunk=chunk, interpret=True)
    ref_p = np.asarray(pallas_fb.bucketed_collapse(posts, jc))
    got_p, got_c = fb_generic.forward_backward_chunked(
        _torch_cols(cols, np.float32), chunk=chunk)
    assert fb_generic.last_walk == (2, N, -(-N // chunk))
    np.testing.assert_allclose(got_p.numpy(), ref_p, rtol=RTOL32, atol=ATOL32)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(ref_c), rtol=RTOL32, atol=0)


@pytest.mark.parametrize("mix", [((0.8, 2), (0.2, 16)), ((0.5, 4), (0.5, 12))],
                         ids=["2_16", "4_12"])
def test_chunked_fb_matches_pallas_core_at_float32_scale(mix):
    """On columns whose raw posteriors stay far above float32's underflow
    (k-mers only on alleles the column has, read counts from a true path
    pair), column by column: the sums at rtol, and each column divided
    by its sum at rtol/atol."""
    N, P, chunk = 45, 8, 16
    cols = multiallelic_columns(N, P, 16, allele_mix(N, 3, mix), batch_dims=(2,), seed=3)
    jc = _f32_device(JaxColumnArrays(*cols))
    posts, _ = pallas_fb._fb_pallas_e_core(
        pallas_fb.bucketed_state_emissions(jc), jc.trans, jc.is_last, jc.scale,
        P=P, chunk=chunk, interpret=True)
    ref = np.asarray(pallas_fb.bucketed_collapse(posts, jc))
    got, _ = fb_generic.forward_backward_chunked(_torch_cols(cols, np.float32), chunk=chunk)
    got = got.numpy()
    s_got, s_ref = got.sum((-2, -1), keepdims=True), ref.sum((-2, -1), keepdims=True)
    assert s_ref.min() > 1e-20
    np.testing.assert_allclose(s_got, s_ref, rtol=RTOL32)
    np.testing.assert_allclose(got / s_got, ref / s_ref, rtol=RTOL32, atol=ATOL32)


@pytest.mark.parametrize("N,chunk", [(70, 16), (47, 5), (33, 33), (20, 1)])
def test_chunked_fb_float64_matches_scan(N, chunk):
    cols = _f64(_mixed_allele_columns(2, N, 6, 4, A_hi=10, seed=11))
    ref_p, ref_c = jax.vmap(forward_backward)(_jax_cols(cols, np.float64))
    got_p, got_c = fb_generic.forward_backward_chunked(
        _torch_cols(cols, np.float64), chunk=chunk)
    assert got_p.dtype == torch.float64
    np.testing.assert_allclose(got_p.numpy(), np.asarray(ref_p), rtol=1e-12, atol=1e-300)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(ref_c), rtol=1e-12)


def test_padded_tail_stays_exact():
    """Bucket padding after the last real column (zero E, nr_local 0)
    leaves every real column exact and yields no NaN."""
    cols = _f64(_mixed_allele_columns(1, 24, 6, 4, A_hi=9, seed=13))
    ref_p, _ = jax.vmap(forward_backward)(_jax_cols(cols, np.float64))
    tc = _torch_cols(cols, np.float64)
    pad = 8

    def padded(x, fill=0):
        tail = torch.full((1, pad) + tuple(x.shape[2:]), fill, dtype=x.dtype)
        return torch.cat([x, tail], dim=1)

    tr_pad = padded(tc.trans)
    tr_pad[:, 24:, 0] = 1.0
    tp = tc._replace(**{k: padded(getattr(tc, k)) for k in tc._fields
                        if k not in ("trans", "all_zeros")},
                     trans=tr_pad, all_zeros=padded(tc.all_zeros, True))
    got_p, _ = fb_generic.forward_backward_chunked(tp, chunk=10)
    assert torch.isfinite(got_p).all()
    np.testing.assert_allclose(got_p[:, :24].numpy(), np.asarray(ref_p),
                               rtol=1e-12, atol=1e-300)


@pytest.mark.parametrize("A_hi,segment,route,chunks", [
    (4, 1 << 17, "torch_ref", None),
    (8, 1 << 17, "torch_ref", None),
    (12, 1 << 17, "torch_generic", 1),
    (4, 16, "torch_generic", 3),
])
def test_routing_rule(monkeypatch, A_hi, segment, route, chunks):
    monkeypatch.setattr(fb_generic, "SEGMENT", segment)
    cols = _mixed_allele_columns(2, 40, 6, 4, A_hi=A_hi, seed=2)
    fb_generic.last_walk = (0, 0, 0)
    posts, _ = batch.forward_backward_batch(_torch_cols(_f64(cols), np.float64))
    assert batch.last_dispatch == route
    assert posts.shape == (2, 40, A_hi, A_hi)
    if chunks is not None:
        assert fb_generic.last_walk == (2, 40, chunks)
    ref_p, _ = jax.vmap(forward_backward)(_jax_cols(_f64(cols), np.float64))
    np.testing.assert_allclose(posts.numpy(), np.asarray(ref_p), rtol=1e-12, atol=1e-300)


def _card(monkeypatch, total, free):
    """A CUDA device whose properties say ``total`` bytes and whose
    mem_get_info says ``free()`` (a call each time)."""
    class Properties:
        total_memory = total

    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda device=None: Properties)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (free(), total))
    return torch.device("cuda", 0)


def test_pick_chunk_caps_at_segment(monkeypatch):
    """The chunk is at most SEGMENT and N; on the CPU it is that alone,
    on a card also CHUNK_MEMORY_SHARE of the card's total memory over
    five [B, P, P] float32 columns."""
    monkeypatch.setattr(fb_generic, "SEGMENT", 100)
    cpu = torch.device("cpu")
    assert fb_generic.pick_chunk(1000, 8, 2, cpu) == 100
    assert fb_generic.pick_chunk(40, 8, 2, cpu) == 40
    total = 80 << 30
    card = _card(monkeypatch, total, lambda: total)
    assert fb_generic.pick_chunk(1000, 8, 2, card) == 100
    monkeypatch.setattr(fb_generic, "SEGMENT", 1 << 17)
    per_col = 5 * 11 * 200 * 200 * 4
    assert fb_generic.pick_chunk(20_000, 200, 11, card) == int(
        total * fb_generic.CHUNK_MEMORY_SHARE) // per_col
    assert fb_generic.pick_chunk(50, 200, 11, card) == 50


def test_pick_chunk_follows_the_total_not_the_free_memory(monkeypatch):
    """With mem_get_info saying anything from all of the card free to
    almost none, the chunk stays the same; it follows the card's total
    memory alone."""
    rng = np.random.default_rng(0)
    total = 80 << 30
    card = _card(monkeypatch, total, lambda: int(rng.integers(1 << 20, total)))
    chunks = {fb_generic.pick_chunk(20_000, 200, 11, card) for _ in range(50)}
    assert len(chunks) == 1
    half = _card(monkeypatch, total // 2, lambda: total // 2)
    assert fb_generic.pick_chunk(20_000, 200, 11, half) == max(1, chunks.pop() // 2)


def test_out_of_memory_halves_the_chunk(monkeypatch, capsys):
    """A chunk that cannot be allocated (K3's plain version raising
    torch.cuda.OutOfMemoryError past 6 columns) starts the walk over in
    chunks of half as many columns, and a line names the chunk taken;
    the result is the walk's in those chunks."""
    from pangenie_tpu_torch.hmm import fb_kernels

    cols = _torch_cols(_f64(_mixed_allele_columns(2, 40, 6, 4, A_hi=12, seed=3)), np.float64)
    want_p, want_c = fb_generic.forward_backward_chunked(cols, chunk=5)
    forward_e = fb_kernels.forward_e

    def tight(E, *args, **kwargs):
        if E.shape[1] > 6:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (forced)")
        return forward_e(E, *args, **kwargs)

    monkeypatch.setattr(fb_kernels, "forward_e", tight)
    got_p, got_c = fb_generic.forward_backward_chunked(cols, chunk=20)
    err = capsys.readouterr().err
    assert "chunks of 20 columns did not fit the card: taking chunks of 10" in err
    assert "taking chunks of 5" in err
    assert fb_generic.last_walk == (2, 40, 8) and fb_generic.last_chunk == 5
    assert torch.equal(got_p, want_p) and torch.equal(got_c, want_c)
    monkeypatch.setattr(fb_kernels, "forward_e",
                        lambda *a, **k: (_ for _ in ()).throw(torch.cuda.OutOfMemoryError()))
    with pytest.raises(torch.cuda.OutOfMemoryError):
        fb_generic.forward_backward_chunked(cols, chunk=2)


def test_factor_trans_pins_first_column():
    trans = torch.from_numpy(np.random.default_rng(0).random((2, 5, 3)))
    u = fb_generic.factor_trans(trans)
    ref = np.asarray(pallas_fb._factor_trans(jnp.asarray(trans.numpy())))
    np.testing.assert_array_equal(u.numpy(), ref)
    assert u[:, 0].tolist() == [[1.0, 0.0, 0.0]] * 2
