"""The port's PairHMM on the hand-computed oracles of the reference
test suite (reference tests/HMMTest.cpp; the same cases as
tests/test_hmm_reference.py), genotyping only, on the CPU in float64."""

import numpy as np
import pytest
import torch

from pangenie_tpu_torch.hmm.genotyping import PairHMM
from pangenie_tpu_torch.kmers.unique import UniqueKmersRecord
from pangenie_tpu_torch.model.probabilities import ProbabilityTable

torch.set_num_threads(1)


def collect(hmm, pairs=((0, 0), (0, 1), (1, 1))):
    out = []
    for result in hmm.get_genotyping_result():
        for a, b in pairs:
            out.append(float(result.get_genotype_likelihood(a, b)))
    return out


def rec(pos, path_to_allele, kmers=(), undefined=(), coverage=0):
    r = UniqueKmersRecord(pos, path_to_allele)
    for a in undefined:
        r.set_undefined_allele(a)
    for count, alleles in kmers:
        r.insert_kmer(count, alleles)
    r.set_coverage(coverage)
    return r


def probs_cov0(entries, count_max=21):
    p = ProbabilityTable(0, 1, count_max, 0.0)
    for count, cn in entries.items():
        p.modify_probability(0, count, cn)
    return p


def hmm_of(records, probs, recombrate, uniform=False, **kw):
    return PairHMM(records, probs, True, False, recombrate, uniform, 0.25, **kw)


def _case_undefined_alleles1():
    u1 = rec(2000, [0, 1], kmers=[(10, [0])], undefined=[0])
    u2 = rec(3000, [1, 0], kmers=[(20, [0]), (1, [1])])
    probs = probs_cov0({10: (0.1, 0.9, 0.1), 20: (0.01, 0.01, 0.9),
                        1: (0.9, 0.3, 0.1)})
    return hmm_of([u1, u2], probs, 446.287102628), [
        0.02396597038, 0.52185641164, 0.45417761795,
        0.97855858361, 0.01875778106, 0.00268363531], 1e-9


def _case_undefined_alleles2():
    u1 = rec(2000, [0, 0])
    u2 = rec(3000, [1, 0], kmers=[(20, [1]), (1, [0])], undefined=[0])
    probs = probs_cov0({20: (0.01, 0.01, 0.9), 1: (0.9, 0.3, 0.1)})
    return hmm_of([u1, u2], probs, 446.287102628), [
        0.0, 0.0, 0.0, 0.11813512445, 0.1617937574, 0.72007111814], 1e-9


def _case_only_undefined_alleles():
    u1 = rec(2000, [0, 1], kmers=[(10, [0]), (10, [1])], undefined=[0, 1])
    u2 = rec(3000, [1, 0], kmers=[(20, [0]), (1, [1])], undefined=[0, 1])
    probs = probs_cov0({10: (0.1, 0.9, 0.1), 20: (0.01, 0.01, 0.9),
                        1: (0.9, 0.3, 0.1)})
    return hmm_of([u1, u2], probs, 446.287102628), [0.0] * 6, 0.0


def _case_no_alt_allele():
    u = rec(2000, [0, 0, 0], kmers=[(10, [0, 1]), (5, [])])
    probs = probs_cov0({10: (0.1, 0.2, 0.9), 5: (0.3, 0.4, 0.1)}, 11)
    return hmm_of([u], probs, 1.26), [0.0, 0.0, 0.0], 0.0


def _case_no_ref_allele():
    u = rec(2000, [1, 1, 1], kmers=[(20, [0, 1]), (10, [])])
    probs = probs_cov0({20: (0.1, 0.2, 0.9), 10: (0.3, 0.4, 0.1)})
    return hmm_of([u], probs, 1.26), [0.0, 0.0, 1.0], 1e-12


def _case_no_unique_kmers():
    u1 = rec(2000, [0, 1])
    u2 = rec(3000, [0, 1])
    return hmm_of([u1, u2], ProbabilityTable(), 446.287102628), [
        0.25, 0.5, 0.25, 0.25, 0.5, 0.25], 1e-9


def _case_no_unique_kmers2():
    u1 = rec(2000, [0, 0, 1])
    u2 = rec(3000, [0, 1, 1])
    return hmm_of([u1, u2], ProbabilityTable(), 1070.02483182), [
        4 / 9, 4 / 9, 1 / 9, 1 / 9, 4 / 9, 4 / 9], 1e-9


def _case_no_unique_kmers3():
    u1 = rec(2000, [0, 1], kmers=[(10, [0]), (10, [1])])
    u2 = rec(3000, [0, 1])
    u3 = rec(4000, [0, 1], kmers=[(10, [0]), (9, [1])])
    probs = probs_cov0({10: (0.1, 0.9, 0.1), 9: (0.1, 0.8, 0.1)})
    return hmm_of([u1, u2, u3], probs, 446.287102628), [
        0.00264169937, 0.99471660125, 0.00264169937,
        0.02552917716, 0.94894164567, 0.02552917716,
        0.002961313333, 0.99407737333, 0.002961313333], 1e-9


def _case_no_unique_kmers_uniform():
    u1 = rec(2000, [0, 1, 1])
    u2 = rec(3000, [0, 0, 1])
    return hmm_of([u1, u2], ProbabilityTable(), 1.26, uniform=True), [
        1 / 9, 4 / 9, 4 / 9, 4 / 9, 4 / 9, 1 / 9], 1e-9


def _case_only_kmers():
    u1 = rec(2000, [0, 1], kmers=[(10, [0]), (12, [1])])
    u2 = rec(3000, [0, 1], kmers=[(1, [0]), (20, [1])])
    u3 = rec(4000, [0, 1], kmers=[(5, [0]), (7, [1])])
    probs = probs_cov0({
        10: (0.05, 0.9, 0.05), 12: (0.1, 0.7, 0.2), 1: (0.9, 0.07, 0.03),
        20: (0.1, 0.2, 0.7), 5: (0.6, 0.3, 0.1), 7: (0.3, 0.4, 0.3),
    })
    return hmm_of([u1, u2, u3], probs, 1.26, uniform=True), [
        0.00392156862745098, 0.988235294117647, 0.00784313725490196,
        0.0045385779122541605, 0.0423600605143722, 0.9531013615733737,
        0.06666666666666667, 0.5333333333333333, 0.39999999999999997], 1e-9


def _case_emissions_zero():
    u1 = rec(1000, [0, 1], kmers=[(10, [0]), (10, [1])])
    u2 = rec(2000, [1, 1], kmers=[(0, [1]), (0, [1])])
    u3 = rec(3000, [0, 1], kmers=[(10, [0]), (10, [1])])
    probs = probs_cov0({10: (0.0, 1.0, 0.0), 0: (1.0, 0.0, 0.0)}, 11)
    return hmm_of([u1, u2, u3], probs, 446.287102628), [
        0.0, 1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 1.0, 0.0], 1e-12


def _case_underflow():
    u1 = rec(1000, [0, 1], kmers=[(10, [0]), (10, [1])])
    u2 = rec(2000, [0, 1], kmers=[(20, [0]), (0, [1])])
    u3 = rec(3000, [0, 1], kmers=[(10, [0]), (10, [1])])
    probs = probs_cov0({10: (0.0, 1.0, 0.0), 20: (0.0, 0.0, 1.0),
                        0: (1.0, 0.0, 0.0)})
    return hmm_of([u1, u2, u3], probs, 0.0), [
        0.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 1.0, 0.0], 1e-12


def _case_neutral_kmers():
    u1 = rec(2000, [0, 1],
             kmers=[(10, [0]), (10, [1]), (12, [0, 1]), (5, [0, 1])])
    u2 = rec(3000, [0, 1],
             kmers=[(20, [0]), (1, [1]), (15, [0, 1]), (9, [0, 1])])
    probs = probs_cov0({
        10: (0.1, 0.9, 0.1), 12: (0.05, 0.45, 0.5), 5: (0.4, 0.5, 0.1),
        20: (0.01, 0.01, 0.9), 1: (0.9, 0.3, 0.1), 15: (0.01, 0.49, 0.5),
        9: (0.3, 0.4, 0.3),
    })
    return hmm_of([u1, u2], probs, 446.287102628), [
        0.0509465435, 0.9483202731, 0.0007331832,
        0.9678020017, 0.031003181, 0.0011948172], 1e-9


def _case_only_paths_multiallelic():
    u1 = rec(2000, [0, 2, 1, 1], kmers=[(10, [0]), (10, [1])])
    u2 = rec(3000, [0, 0, 2, 1], kmers=[(20, [0]), (1, [1])])
    probs = probs_cov0({10: (0.1, 0.9, 0.1), 20: (0.01, 0.01, 0.9),
                        1: (0.9, 0.3, 0.1)})
    return hmm_of([u1, u2], probs, 446.287102628, only_paths=[0, 3]), [
        0.0509465435, 0.9483202731, 0.0007331832,
        0.9678020017, 0.031003181, 0.0011948172], 1e-9


def _case_only_paths2():
    u1 = rec(2000, [0, 1, 2], kmers=[(12, [2])])
    u2 = rec(3000, [0, 1, 2], kmers=[(12, [2])])
    probs = probs_cov0({12: (0.05, 0.8, 0.15)}, 13)
    return hmm_of([u1, u2], probs, 446.287102628, only_paths=[0, 1]), [
        0.25, 0.5, 0.25, 0.25, 0.5, 0.25], 1e-9


CASES = {name[len("_case_"):]: fn for name, fn in dict(globals()).items()
         if name.startswith("_case_")}


@pytest.mark.parametrize("name", sorted(CASES))
def test_reference_oracle(name):
    hmm, expected, atol = CASES[name]()
    got = collect(hmm)
    if atol == 0.0:
        assert got == expected
    else:
        assert np.allclose(got, expected, atol=atol)


def test_undefined_alleles_reprojection():
    hmm, _, _ = _case_undefined_alleles1()
    defined = [[1], [0, 1]]
    expected = [1.0, 0.0, 0.0, 0.97855858361, 0.01875778106, 0.00268363531]
    got = []
    for i, result in enumerate(hmm.get_genotyping_result()):
        final = result.get_specific_likelihoods(defined[i])
        for a, b in ((0, 0), (0, 1), (1, 1)):
            got.append(float(final.get_genotype_likelihood(a, b)))
    assert np.allclose(got, expected, atol=1e-9)


def test_combine_results():
    u1 = rec(2000, [0, 1], kmers=[(10, [0]), (10, [1])], coverage=5)
    u2 = rec(3000, [0, 1], kmers=[(20, [0]), (5, [1])], coverage=5)
    probs = ProbabilityTable(5, 10, 30, 0.0)
    probs.modify_probability(5, 10, (0.1, 0.9, 0.1))
    probs.modify_probability(5, 20, (0.01, 0.01, 0.9))
    probs.modify_probability(5, 5, (0.9, 0.3, 0.1))
    hmm1 = hmm_of([u1, u2], probs, 446.287102628)
    like1 = collect(hmm1)
    hmm2, like2, _ = _case_only_paths2()
    like2 = collect(hmm2)
    hmm1.combine_likelihoods(hmm2)
    assert np.allclose(collect(hmm1), [a + b for a, b in zip(like1, like2)],
                       atol=1e-12)


def test_normalize_raw_values():
    u1 = rec(2000, [0, 1, 2], kmers=[(12, [2])])
    u2 = rec(3000, [0, 1, 2], kmers=[(12, [2])])
    probs = probs_cov0({12: (0.05, 0.8, 0.15)}, 13)
    hmm = hmm_of([u1, u2], probs, 446.287102628, only_paths=[0, 1],
                 normalize=False)
    assert np.allclose(collect(hmm), [0.000625, 0.00125, 0.000625,
                                      0.0125, 0.025, 0.0125], rtol=1e-12)
    hmm.normalize()
    assert np.allclose(collect(hmm), [0.25, 0.5, 0.25, 0.25, 0.5, 0.25],
                       atol=1e-12)


def test_deferred_batch_matches_single_runs():
    """Two runs of one shape bucket execute as ONE batched
    forward-backward and still reproduce their single-run oracles."""
    single_a, expected_a, _ = _case_neutral_kmers()
    single_b, expected_b, _ = _case_only_kmers()
    runs = [
        PairHMM(h.records, probs, True, False, rr, uniform, 0.25, defer=True)
        for h, probs, rr, uniform in (
            (single_a, probs_cov0({
                10: (0.1, 0.9, 0.1), 12: (0.05, 0.45, 0.5), 5: (0.4, 0.5, 0.1),
                20: (0.01, 0.01, 0.9), 1: (0.9, 0.3, 0.1), 15: (0.01, 0.49, 0.5),
                9: (0.3, 0.4, 0.3)}), 446.287102628, False),
            (single_b, probs_cov0({
                10: (0.05, 0.9, 0.05), 12: (0.1, 0.7, 0.2), 1: (0.9, 0.07, 0.03),
                20: (0.1, 0.2, 0.7), 5: (0.6, 0.3, 0.1), 7: (0.3, 0.4, 0.3)}),
             1.26, True),
        )
    ]
    assert [r.device_cols.lp.shape for r in runs][0] == runs[1].device_cols.lp.shape
    assert all(not r.get_genotyping_result()[0].likelihoods for r in runs)
    PairHMM.run_deferred(runs)
    assert np.allclose(collect(runs[0]), expected_a, atol=1e-9)
    assert np.allclose(collect(runs[1]), expected_b, atol=1e-9)
    assert collect(runs[0]) == collect(single_a)
    assert collect(runs[1]) == collect(single_b)


def test_phasing_runs_beside_genotyping():
    """PairHMM(run_genotyping=True, run_phasing=True) on HMMTest.cpp's 'HMM
    no_unique_kmers3' (the middle column has no k-mers): the oracle's
    likelihoods and haplotypes (one path each, either way round), and
    the phasing run's k-mer counts and coverage written at the column
    index (src/hmm.cpp:164-165)."""
    u1 = rec(2000, [0, 1], kmers=[(10, [0]), (10, [1])], coverage=0)
    u2 = rec(3000, [0, 1])
    u3 = rec(4000, [0, 1], kmers=[(10, [0]), (9, [1])])
    probs = probs_cov0({10: (0.1, 0.9, 0.1), 9: (0.1, 0.8, 0.1)})
    hmm = PairHMM([u1, u2, u3], probs, True, True, 446.287102628, False, 0.25)
    expected = [0.00264169937, 0.99471660125, 0.00264169937,
                0.02552917716, 0.94894164567, 0.02552917716,
                0.002961313333, 0.99407737333, 0.002961313333]
    assert np.allclose(collect(hmm), expected, atol=1e-9)
    h1 = [g.haplotype_1 for g in hmm.get_genotyping_result()]
    h2 = [g.haplotype_2 for g in hmm.get_genotyping_result()]
    assert sorted([h1, h2]) == [[0, 0, 0], [1, 1, 1]]
    phasing_only = PairHMM([u1, u2, u3], probs, False, True, 446.287102628, False, 0.25)
    got = phasing_only.get_genotyping_result()
    assert [(g.haplotype_1, g.haplotype_2) for g in got] == list(zip(h1, h2))
    assert [g.nr_unique_kmers for g in got] == [2, 0, 2]
    assert all(not g.likelihoods for g in got)
