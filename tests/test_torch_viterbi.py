"""The port's phasing Viterbi (``pangenie_tpu_torch/hmm/viterbi.py``, the
plain version of kernel V1) against the reference package's
(``pangenie_tpu/hmm/viterbi.py``), on the CPU in float64.

The factored best-predecessor step must give the dense oracle's values
and indices (the port's and the reference's), ties included; the states
of a whole chain must equal the reference's (integer equality) on the
cases of the reference's own tests (``test_viterbi_fast.py``,
``test_viterbi_oracle.py``), where chains of 2048 columns or more take
the reference's two-pass ``_viterbi_fast``; the checkpointed form must
give the unsegmented run's states.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pangenie_tpu.hmm.viterbi import viterbi as jax_viterbi
from pangenie_tpu.utils.synthetic import synthetic_columns
from pangenie_tpu_torch.hmm import viterbi as V
from pangenie_tpu_torch.hmm.forward_backward import columns_from_numpy
from pangenie_tpu_torch.hmm.genotyping import PairHMM
from pangenie_tpu_torch.kmers.unique import UniqueKmersRecord
from pangenie_tpu_torch.model.probabilities import ProbabilityTable
from test_viterbi_oracle import brute_viterbi

torch.set_num_threads(1)
# the reference's hmm package re-exports the viterbi FUNCTION under the
# module's name
jax_viterbi_mod = importlib.import_module("pangenie_tpu.hmm.viterbi")


def _check_step(lv, lt, P):
    lv_t = torch.from_numpy(np.asarray(lv, np.float64))[None]
    lt_t = torch.from_numpy(np.asarray(lt, np.float64))[None]
    fv, fi = V._prev_best_factored(lv_t, lt_t, P)
    dv, di = V._prev_best_dense(lv_t, lt_t, P)
    # where every candidate is -inf the factored form's index is its
    # own (the reference's too, held below), not the dense last index
    finite = torch.isfinite(dv)
    assert torch.equal(fv, dv) and torch.equal(fi[finite], di[finite])
    jv, ji = jax.jit(jax_viterbi_mod._prev_best_factored, static_argnums=2)(
        jnp.asarray(lv, jnp.float64), jnp.asarray(lt, jnp.float64), P)
    np.testing.assert_array_equal(fv[0].numpy(), np.asarray(jv))
    np.testing.assert_array_equal(fi[0].numpy(), np.asarray(ji))


@pytest.mark.parametrize("P", [1, 2, 3, 5, 8, 13])
def test_factored_step_matches_dense_random(P):
    rng = np.random.default_rng(P)
    for _ in range(8):
        lv = rng.normal(size=P * P)
        lt = np.sort(rng.normal(size=3))[::-1].copy()      # stay >= switch
        _check_step(lv, lt, P)


@pytest.mark.parametrize("P", [2, 3, 6])
def test_factored_step_matches_dense_ties(P):
    rng = np.random.default_rng(100 + P)
    cases = [
        np.zeros(P * P),                                   # all equal
        np.repeat(rng.normal(size=P), P),                  # equal rows
        np.tile(rng.normal(size=P), P),                    # equal columns
        rng.choice([0.0, 1.0], size=P * P),                # heavy duplicates
        rng.choice([-1.0, 0.0], size=P * P),
        np.full(P * P, -np.inf),                           # an all-zero column
        np.where(rng.random(P * P) < 0.5, -np.inf, 0.0),   # -inf beside ties
    ]
    lts = [np.array([0.0, 0.0, 0.0]), np.array([0.0, -1.0, -2.0]),
           np.array([-0.1, -0.1, -3.0])]
    for lv in cases:
        for lt in lts:
            _check_step(lv, lt, P)


def test_factored_step_matches_dense_padding_transitions():
    """Padding columns carry trans = (1, 0, 0): lt = (0, -inf, -inf)."""
    rng = np.random.default_rng(4)
    with np.errstate(divide="ignore"):
        lt = np.log(np.array([1.0, 0.0, 0.0]))
    for P in (1, 4, 7):
        _check_step(rng.normal(size=P * P), lt, P)
        _check_step(np.where(rng.random(P * P) < 0.3, -np.inf, rng.normal(size=P * P)),
                    lt, P)


def test_top2_last_on_an_all_minus_inf_slice():
    """a1 is the last index, and a2 the last index too (the masked slot
    is -inf like every other), as the reference's reductions give."""
    x = torch.full((2, 5), float("-inf"), dtype=torch.float64)
    x[1, 2] = 0.0
    m1, a1, m2, a2 = V._top2_last(x, 1)
    assert a1.tolist() == [4, 2] and a2.tolist() == [4, 4]
    assert m2.tolist() == [float("-inf")] * 2
    jm = [np.asarray(v) for v in jax_viterbi_mod._top2_last(jnp.asarray(x.numpy()), 1)]
    assert jm[1].tolist() == a1.tolist() and jm[3].tolist() == a2.tolist()


def _numpy_cols(N, P, K, A=2, seed=0):
    return synthetic_columns(n_columns=N, n_paths=P, n_kmers=K, n_alleles=A, seed=seed)


def _port_states(cols, uniform=False, segment=None):
    port = columns_from_numpy(jax.tree.map(lambda x: np.asarray(x)[None], cols),
                              "cpu", torch.float64)
    if segment is None:
        return V.viterbi(port, uniform)[0].numpy()
    return V.viterbi_segmented(port, segment, uniform)[0].numpy()


def _jax_states(cols, uniform=False):
    jcols = type(cols)(*[jnp.asarray(x) for x in cols])
    return np.asarray(jax_viterbi(jcols, uniform=uniform))


def _path_scores(states, cols, uniform):
    """Scores of a state path in float64 from the reference's own
    inputs, one per stretch of columns that ends at a column whose
    emissions are all zero (every value -inf there, so the column
    restarts uniform): each stretch sums the log transitions into its
    columns and the log emissions of those that are not such a column."""
    jcols = type(cols)(*[jnp.asarray(x) for x in cols])
    logea = np.asarray(jax_viterbi_mod._log_allele_emissions(jcols))
    al = np.asarray(cols.allele_local)
    with np.errstate(divide="ignore"):
        lt = np.zeros_like(cols.trans) if uniform else np.log(cols.trans)
    P = al.shape[1]
    scores, s, prev = [], 0.0, None
    for n, state in enumerate(states.tolist()):
        p1, p2 = divmod(state, P)
        if prev is not None:
            s += lt[n, int(p1 != prev[0]) + int(p2 != prev[1])]
        reset = not np.isfinite(logea[n]).any()
        if reset:
            scores.append(s)
            s = 0.0
        else:
            s += logea[n, al[n, p1], al[n, p2]]
        prev = (p1, p2)
    return np.array(scores + [s])


def _assert_states_or_tie(cols, uniform=False):
    """The port's states equal the reference's, or where they differ the
    two paths tie: rescored in float64 from the same inputs they agree to
    1e-12 relative in every stretch (:func:`_path_scores`). A tie is
    broken by the last ulp of a column's logsumexp, which the two
    packages take with different exp, log and summation order."""
    got, want = _port_states(cols, uniform), _jax_states(cols, uniform)
    if not np.array_equal(got, want):
        a, b = _path_scores(got, cols, uniform), _path_scores(want, cols, uniform)
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=0)
    return got, want


@pytest.mark.parametrize("seed,N,P,A", [
    (9, 64, 6, 2),        # the reference's scan
    (0, 2113, 6, 2),      # its _viterbi_fast, tail columns (N % 64 != 0)
    (1, 2048, 8, 2),      # exact segment multiple
    (2, 2176, 5, 4),      # multiallelic
    (5, 300, 3, 16),      # A > 8: the reference's scan
])
def test_viterbi_matches_reference(seed, N, P, A):
    _assert_states_or_tie(_numpy_cols(N, P, 8, A=A, seed=seed))


def test_viterbi_matches_reference_uniform():
    _assert_states_or_tie(_numpy_cols(2100, 6, 8, seed=3), True)


def test_viterbi_matches_reference_tie_heavy():
    """Constant emissions everywhere: every column is a pure tie-break."""
    cols = _numpy_cols(2304, 5, 4, seed=4)
    _assert_states_or_tie(cols._replace(lp=np.zeros_like(cols.lp)))


def test_viterbi_matches_reference_zero_columns():
    """All-zero emission columns (uniform there) and duplicated paths:
    ties through -inf slices and symmetric states."""
    cols = _numpy_cols(200, 6, 8, A=3, seed=6)
    alleles = cols.alleles.copy()
    alleles[:, 3] = alleles[:, 2]                        # a duplicated path
    lp = cols.lp.copy()
    lp[::7] = -np.inf                                    # every emission 0
    _assert_states_or_tie(cols._replace(alleles=alleles, allele_local=alleles, lp=lp))


@pytest.mark.parametrize("segment", [1, 9, 16, 64, 500])
def test_viterbi_segmented_matches_full(segment):
    cols = _numpy_cols(300, 5, 6, A=3, seed=12)
    full = _port_states(cols)
    np.testing.assert_array_equal(_port_states(cols, segment=segment), full)
    np.testing.assert_array_equal(_port_states(cols, True, segment=segment),
                                  _port_states(cols, True))


def test_viterbi_batched_chains_match_single_runs():
    """B=3 chains in one call give each chain's own states."""
    cols = [_numpy_cols(130, 4, 6, A=2, seed=s) for s in (20, 21, 22)]
    stacked = type(cols[0])(*[np.stack(xs) for xs in zip(*cols)])
    port = columns_from_numpy(stacked, "cpu", torch.float64)
    got = V.viterbi(port).numpy()
    for b, c in enumerate(cols):
        np.testing.assert_array_equal(got[b], _port_states(c))


def test_viterbi_pads_to_a_length_as_pairhmm_does():
    """``length`` appends the padding columns of a bucket: the states of
    the padded chain equal the reference's on columns padded by hand."""
    cols = _numpy_cols(100, 4, 6, A=2, seed=30)
    port = columns_from_numpy(jax.tree.map(lambda x: np.asarray(x)[None], cols),
                              "cpu", torch.float64)
    got = V.viterbi(port, length=128)[0].numpy()
    pad = 28

    def extend(x, fill):
        return np.concatenate([x, np.full((pad,) + x.shape[1:], fill, x.dtype)])

    trans = extend(cols.trans, 0.0)
    trans[100:, 0] = 1.0
    padded = cols._replace(
        lp=extend(cols.lp, 0.0), incidence=extend(cols.incidence, False),
        kmer_mask=extend(cols.kmer_mask, False), alleles=extend(cols.alleles, 0),
        undefined=extend(cols.undefined, False), all_zeros=extend(cols.all_zeros, True),
        scale=extend(cols.scale, 0.0), trans=trans,
        allele_local=extend(cols.allele_local, 0), nr_local=extend(cols.nr_local, 0),
        is_last=extend(cols.is_last, False))
    np.testing.assert_array_equal(got, _jax_states(padded))


def _oracle_probs():
    probs = ProbabilityTable(5, 10, 40, 0.0)
    for count, cn in [(10, (0.1, 0.9, 0.1)), (20, (0.01, 0.01, 0.9)),
                      (5, (0.9, 0.3, 0.1)), (15, (0.2, 0.5, 0.3)),
                      (30, (0.05, 0.2, 0.75))]:
        probs.modify_probability(5, count, cn)
    return probs


def test_phasing_run_matches_long_double_oracle():
    """PairHMM phasing on random records against the reference's
    brute-force long-double Viterbi (tests/test_viterbi_oracle.py)."""
    rng = np.random.default_rng(42)
    probs = _oracle_probs()
    checked = 0
    for trial in range(8):
        P = int(rng.integers(2, 5))
        N = int(rng.integers(2, 10))
        records = []
        pos = 1000
        for _ in range(N):
            pos += int(rng.integers(50, 4000))
            rec = UniqueKmersRecord(pos, rng.integers(0, 3, P).tolist())
            rec.set_coverage(5)
            for _ in range(int(rng.integers(0, 4))):
                count = int(rng.choice([5, 10, 15, 20, 30]))
                rec.insert_kmer(count, [int(rng.integers(0, 3))])
            records.append(rec)
        try:
            hmm = PairHMM(records, probs, False, True, 2.0, False, 100.0)
        except RuntimeError:
            continue  # all columns skipped
        expected = brute_viterbi(records, probs, 2.0, 100.0)
        for idx, (h1, h2) in expected.items():
            g = hmm.get_genotyping_result()[idx]
            assert (g.haplotype_1, g.haplotype_2) == (h1, h2), (trial, idx)
        checked += 1
    assert checked >= 4
