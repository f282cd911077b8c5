"""The port's haplotype-sampling DP vs the reference package.

The plain sampling DP (the CPU path of kernel S1) and the greedy loop
``sample_group`` against JAX ``_viterbi_iteration`` / ``_sample_group``
on the same numpy inputs: paths and uint32 scores must be
bit-identical. Costs drawn from 0..3 force ties; masked paths, neutral
padding columns and an N=4096 group (where JAX takes its blocked
formulation) are covered. The checkpointed scan (S1-seg) against JAX
``_viterbi_iteration_segmented`` and the full scan, and the batched
driver with a budget that sends every chromosome through it against
JAX ``sample_panels_batched``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pangenie_tpu.hmm import sampling as jax_s
from pangenie_tpu_torch.hmm import sampling as torch_s

torch.set_num_threads(1)


def _iteration_inputs(seed, C, N, P, max_cost, masked):
    rng = np.random.default_rng(seed)
    cost = rng.integers(0, max_cost + 1, (C, N, P)).astype(np.uint32)
    mask = rng.random((C, N, P)) >= masked
    switch = rng.integers(0, 6, (C, N)).astype(np.uint32)
    return cost, mask, switch


@pytest.mark.parametrize("seed,C,N,P,max_cost,masked", [
    (0, 1, 40, 5, 3, 0.0),      # forced ties
    (1, 2, 57, 7, 3, 0.3),      # masked paths
    (2, 3, 33, 1, 3, 0.2),      # a single path (second minimum absent)
    (3, 2, 64, 12, 60, 0.5),    # wide costs, many masked
    (4, 1, 25, 6, 3, 0.95),     # nearly everything masked: dead columns
])
def test_viterbi_iteration_bit_identical(seed, C, N, P, max_cost, masked):
    cost, mask, switch = _iteration_inputs(seed, C, N, P, max_cost, masked)
    ref_paths, ref_scores = jax.vmap(jax_s._viterbi_iteration)(
        jnp.asarray(cost), jnp.asarray(mask), jnp.asarray(switch)
    )
    paths, scores = torch_s.viterbi_iteration(
        torch.from_numpy(cost.view(np.int32)), torch.from_numpy(mask),
        torch.from_numpy(switch.view(np.int32)),
    )
    np.testing.assert_array_equal(paths.numpy(), np.asarray(ref_paths))
    np.testing.assert_array_equal(scores.numpy(), np.asarray(ref_scores).astype(np.int64))


def test_saturating_scores():
    """Costs near 2^32 saturate at 0xFFFFFFFF as uint32 adds do."""
    C, N, P = 1, 6, 3
    cost = np.full((C, N, P), 0xF0000000, dtype=np.uint32)
    cost[0, :, 1] = 0x7FFFFFFF
    mask = np.ones((C, N, P), dtype=bool)
    switch = np.full((C, N), 0xFFFFFFF0, dtype=np.uint32)
    ref_paths, ref_scores = jax.vmap(jax_s._viterbi_iteration)(
        jnp.asarray(cost), jnp.asarray(mask), jnp.asarray(switch)
    )
    paths, scores = torch_s.viterbi_iteration_plain(
        torch.from_numpy(cost.view(np.int32)), torch.from_numpy(mask),
        torch.from_numpy(switch.view(np.int32)),
    )
    np.testing.assert_array_equal(paths.numpy(), np.asarray(ref_paths))
    assert int(scores[0]) == int(np.asarray(ref_scores)[0]) == 0xFFFFFFFF


def _group_inputs(seed, C, N, P, A, n_valid):
    rng = np.random.default_rng(seed)
    costs = rng.integers(0, 4, (C, N, A)).astype(np.uint32)
    costs[:, :, A - 1] = 50          # an undefined allele's cost
    alleles = rng.integers(0, A, (C, N, P)).astype(np.int32)
    switch = rng.integers(1, 40, (C, N)).astype(np.uint32)
    valid = np.zeros((C, N), dtype=bool)
    for c, n in enumerate(n_valid):
        valid[c, :n] = True
        # neutral padding (sampling.py:1012-1020): cost 0, switch 1
        costs[c, n:] = 0
        alleles[c, n:] = 0
        switch[c, n:] = 1
    return costs, alleles, switch, valid


def _compare_group(seed, C, N, P, A, n_valid, size, penalty):
    costs, alleles, switch, valid = _group_inputs(seed, C, N, P, A, n_valid)
    ref = jax_s._sample_group(
        jnp.asarray(costs), jnp.asarray(alleles), jnp.asarray(switch),
        jnp.asarray(valid), size, penalty,
    )
    got = torch_s.sample_group(
        torch.from_numpy(costs.view(np.int32)),
        torch.from_numpy(alleles),
        torch.from_numpy(switch.view(np.int32)),
        torch.from_numpy(valid), size, penalty,
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("seed,C,N,P,A,n_valid,size,penalty", [
    (0, 1, 48, 6, 3, [48], 4, 5),
    (1, 2, 64, 9, 4, [64, 41], 5, 5),      # neutral padding columns
    (2, 3, 32, 5, 2, [32, 20, 9], 6, 10),  # more iterations than paths
])
def test_sample_group_bit_identical(seed, C, N, P, A, n_valid, size, penalty):
    _compare_group(seed, C, N, P, A, n_valid, size, penalty)


def test_sample_group_vs_blocked_jax_path():
    """N=4096: the reference takes its blocked min-plus formulation;
    the port's column DP must give the same paths."""
    N = 4096
    assert jax_s._blocked_eligible(N) and N % jax_s._BLOCK_L == 0
    _compare_group(7, 2, N, 6, 3, [N, 3000], 2, 5)


def _make_records(cls, n, P, seed=None):
    recs = []
    r2 = np.random.default_rng(n if seed is None else seed)
    for i in range(n):
        path_to_allele = r2.integers(0, 3, P).tolist()
        rec = cls(1000 + 137 * i, path_to_allele)
        for _ in range(int(r2.integers(0, 5))):
            rec.insert_kmer(int(r2.integers(0, 8)), [int(r2.integers(0, 3))])
        recs.append(rec)
    return recs


def test_sample_panels_batched_matches_jax():
    """Whole driver on records of two chromosomes of different lengths
    (one group, padded): sampled paths and the records' path sets."""
    from pangenie_tpu.kmers.unique import UniqueKmersRecord as JRecord
    from pangenie_tpu_torch.kmers.unique import UniqueKmersRecord as TRecord

    P = 9
    jrecs = {"chrA": _make_records(JRecord, 70, P), "chrB": _make_records(JRecord, 50, P)}
    trecs = {"chrA": _make_records(TRecord, 70, P), "chrB": _make_records(TRecord, 50, P)}
    ref = jax_s.sample_panels_batched(jrecs, 4, 1.26, 0.01, True, {}, 5)
    got = torch_s.sample_panels_batched(trecs, 4, 1.26, 0.01, True, {}, 5)
    assert got == ref
    for chrom in jrecs:
        for a, b in zip(jrecs[chrom], trecs[chrom]):
            assert a.get_path_ids() == b.get_path_ids()


@pytest.mark.parametrize("P,penalty", [(9, 5), (40, 30)])
def test_sample_panels_batched_segmented_route_matches_jax(tmp_path, P, penalty):
    """A budget under every chromosome's group peak sends each through
    the checkpointed scan, in segments of several columns: the same
    sampled paths, records' path sets and paths TSVs as JAX's driver
    (whose 1 GiB rule keeps these chromosomes in its batched scan)."""
    from pangenie_tpu.kmers.unique import UniqueKmersRecord as JRecord
    from pangenie_tpu_torch.kmers.unique import UniqueKmersRecord as TRecord

    sizes = {"chrA": 70, "chrB": 50, "chrC": 40}
    jrecs = {c: _make_records(JRecord, n, P, seed=n + P) for c, n in sizes.items()}
    trecs = {c: _make_records(TRecord, n, P, seed=n + P) for c, n in sizes.items()}
    states = [torch_s._ChromState(c, r, 1.26, 0.01) for c, r in trecs.items()]
    budget = min(torch_s._group_peak([st], 4) for st in states) - 1
    groups, long_states = torch_s.plan_groups(states, 4, 2 << 30, budget)
    assert groups == [] and len(long_states) == 3
    source = torch_s._PanelSegments(states[0], "cpu")
    segment = torch_s.segment_columns(budget, 1, 70, P, source.column_bytes())
    assert 1 < segment < 70 // 2

    def outputs(pkg):
        return {c: str(tmp_path / f"{pkg}_{c}.tsv") for c in sizes}

    ref = jax_s.sample_panels_batched(jrecs, 4, 1.26, 0.01, True, outputs("jax"), penalty)
    got = torch_s.sample_panels_batched(trecs, 4, 1.26, 0.01, True, outputs("torch"),
                                        penalty, budget=budget)
    assert got == ref
    for chrom in sizes:
        for a, b in zip(jrecs[chrom], trecs[chrom]):
            assert a.get_path_ids() == b.get_path_ids()
        with open(outputs("jax")[chrom]) as a, open(outputs("torch")[chrom]) as b:
            assert a.read() == b.read()


def _fake_state(name, N, P, A=4):
    st = torch_s._ChromState.__new__(torch_s._ChromState)
    st.N, st.P, st.chromosome = N, P, name
    st.costs = np.zeros((1, A), dtype=np.uint32)
    return st


def test_long_chromosomes_raise():
    """The one refusal left: a budget that does not hold one column of a
    chromosome in the checkpointed scan raises in sample_panels_batched;
    any longer chromosome is sampled
    (test_long_chromosomes_are_routed_to_the_segmented_scan)."""
    from pangenie_tpu_torch.kmers.unique import UniqueKmersRecord as TRecord

    records = {"chrA": _make_records(TRecord, 30, 9)}
    with pytest.raises(RuntimeError, match="does not fit"):
        torch_s.sample_panels_batched(records, 2, 1.26, 0.01, True, {}, 5, budget=100)


def test_long_chromosomes_are_routed_to_the_segmented_scan():
    """A chromosome whose group peak exceeds the device's free memory is
    not refused: plan_groups hands it back apart, for the checkpointed
    scan, while one within the budget is planned like any other (also
    one over the reference's 1 GiB rule for int32 [N, P] backtraces)."""
    st = _fake_state("chrX", (1 << 28) // 4 + 1, 4)
    short = _fake_state("chrY", 1000, 4)
    peak = torch_s.group_peak_bytes(1, st.N, 4, 4, 1)
    assert torch_s.plan_groups([short, st], 1, 2 << 30, peak - 1) == ([[short]], [st])
    assert st.N * st.P * 4 > 1 << 30
    assert torch_s.plan_groups([st], 1, 2 << 30, peak) == ([[st]], [])


def test_groups_split_where_the_budget_ends():
    """Chromosomes of one length class group while their peak fits the
    budget, and go alone where it does not."""
    states = [_fake_state(f"chr{i}", 1000 + i, 9) for i in range(4)]
    two = torch_s.group_peak_bytes(2, 1003, 9, 4, 3)
    groups, long_states = torch_s.plan_groups(states, 3, 2 << 30, two)
    assert [[s.chromosome for s in g] for g in groups] == [["chr0", "chr1"], ["chr2", "chr3"]]
    assert long_states == []
    assert len(torch_s.plan_groups(states, 3, 2 << 30, 1 << 40)[0]) == 1


def test_full_backtrace_equals_the_checkpointed_scan():
    """The plain sampling DP over whole [N, P] backtraces gives the path
    and score of the reference's checkpointed scan (segments of 512
    columns) and of its full scan, at N=3000, P=9."""
    N, P = 3000, 9
    cost, mask, switch = _iteration_inputs(11, 1, N, P, 3, 0.3)
    seg_path, seg_score = jax_s._viterbi_iteration_segmented(cost[0], mask[0], switch[0], 512)
    full_path, full_score = jax_s._viterbi_iteration(
        jnp.asarray(cost[0]), jnp.asarray(mask[0]), jnp.asarray(switch[0]))
    paths, scores = torch_s.viterbi_iteration_plain(
        torch.from_numpy(cost.view(np.int32)), torch.from_numpy(mask),
        torch.from_numpy(switch.view(np.int32)))
    np.testing.assert_array_equal(np.asarray(seg_path), np.asarray(full_path))
    np.testing.assert_array_equal(paths[0].numpy(), np.asarray(seg_path))
    assert int(scores[0]) == int(seg_score) == int(full_score) < torch_s.UINT_MAX


@pytest.fixture(scope="module")
def segmented_cases():
    """(P, N) -> inputs and JAX's full scan of them."""
    cases = {}
    for P, N in ((9, 600), (1025, 530)):
        cost, mask, switch = _iteration_inputs(P, 1, N, P, 3, 0.3)
        full = jax_s._viterbi_iteration(
            jnp.asarray(cost[0]), jnp.asarray(mask[0]), jnp.asarray(switch[0]))
        cases[P] = (cost, mask, switch, np.asarray(full[0]), int(full[1]))
    return cases


@pytest.mark.parametrize("segment", [1, 7, 512, "N"])
@pytest.mark.parametrize("P", [9, 1025])
def test_segmented_scan_matches_jax(segmented_cases, P, segment):
    """The port's checkpointed scan (plain versions on the CPU) against
    JAX ``_viterbi_iteration_segmented`` with the same segment length and
    against JAX's full scan: paths and scores bit-identical."""
    cost, mask, switch, full_path, full_score = segmented_cases[P]
    N = cost.shape[1]
    segment = N if segment == "N" else segment
    if segment in (512, N):  # the reference's own scan, where it is quick
        seg_path, seg_score = jax_s._viterbi_iteration_segmented(
            cost[0], mask[0], switch[0], segment)
        np.testing.assert_array_equal(np.asarray(seg_path), full_path)
        assert int(seg_score) == full_score
    t_cost, t_mask = torch.from_numpy(cost.view(np.int32)), torch.from_numpy(mask)
    t_switch = torch.from_numpy(switch.view(np.int32))
    asked = []

    def source(lo, hi):
        asked.append((lo, hi))
        return t_cost[:, lo:hi], t_mask[:, lo:hi], t_switch[:, lo:hi]

    paths, best = torch_s.viterbi_iteration_segmented(source, 1, N, P, segment, "cpu")
    np.testing.assert_array_equal(paths[0].numpy(), full_path)
    assert int(best[0]) == full_score < torch_s.UINT_MAX
    # forward over every segment but the last, then all in reverse
    bounds = [(lo, min(N, lo + segment)) for lo in range(0, N, segment)]
    assert asked == bounds[:-1] + bounds[::-1]
