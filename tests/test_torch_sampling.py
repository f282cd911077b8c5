"""The port's haplotype-sampling DP vs the reference package.

The plain sampling DP (the CPU path of kernel S1) and the greedy loop
``sample_group`` against JAX ``_viterbi_iteration`` / ``_sample_group``
on the same numpy inputs: paths and uint32 scores must be
bit-identical. Costs drawn from 0..3 force ties; masked paths, neutral
padding columns and an N=4096 group (where JAX takes its blocked
formulation) are covered.
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
        torch.from_numpy(alleles.astype(np.int64)),
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


def test_sample_panels_batched_matches_jax():
    """Whole driver on records of two chromosomes of different lengths
    (one group, padded): sampled paths and the records' path sets."""
    from pangenie_tpu.kmers.unique import UniqueKmersRecord as JRecord
    from pangenie_tpu_torch.kmers.unique import UniqueKmersRecord as TRecord

    def make(cls, n, P):
        recs = []
        r2 = np.random.default_rng(n)
        for i in range(n):
            path_to_allele = r2.integers(0, 3, P).tolist()
            rec = cls(1000 + 137 * i, path_to_allele)
            for _ in range(int(r2.integers(0, 5))):
                rec.insert_kmer(int(r2.integers(0, 8)), [int(r2.integers(0, 3))])
            recs.append(rec)
        return recs

    P = 9
    jrecs = {"chrA": make(JRecord, 70, P), "chrB": make(JRecord, 50, P)}
    trecs = {"chrA": make(TRecord, 70, P), "chrB": make(TRecord, 50, P)}
    ref = jax_s.sample_panels_batched(jrecs, 4, 1.26, 0.01, True, {}, 5)
    got = torch_s.sample_panels_batched(trecs, 4, 1.26, 0.01, True, {}, 5)
    assert got == ref
    for chrom in jrecs:
        for a, b in zip(jrecs[chrom], trecs[chrom]):
            assert a.get_path_ids() == b.get_path_ids()


def _fake_state(name, N, P, A=4):
    st = torch_s._ChromState.__new__(torch_s._ChromState)
    st.N, st.P, st.chromosome = N, P, name
    st.costs = np.zeros((1, A), dtype=np.uint32)
    return st


def test_long_chromosomes_raise(monkeypatch):
    """A chromosome whose group peak exceeds the device's free memory
    needs the checkpointed scan, which is not ported:
    sample_panels_batched raises, naming the peak and the budget, before
    any device work. One over the reference's 1 GiB rule for int32
    [N, P] backtraces but within the budget is planned like any other."""
    st = _fake_state("chrX", (1 << 28) // 4 + 1, 4)
    peak = torch_s.group_peak_bytes(1, st.N, 4, 4, 1)
    monkeypatch.setattr(torch_s, "_ChromState", lambda *a, **k: st)
    monkeypatch.setattr(torch_s, "memory_budget", lambda device: 12345)
    with pytest.raises(NotImplementedError, match=f"{peak} bytes .* the 12345 bytes free"):
        torch_s.sample_panels_batched({"chrX": [object()]}, 1)
    assert st.N * st.P * 4 > 1 << 30
    assert torch_s.plan_groups([st], 1, 2 << 30, peak) == [[st]]


def test_groups_split_where_the_budget_ends():
    """Chromosomes of one length class group while their peak fits the
    budget, and go alone where it does not."""
    states = [_fake_state(f"chr{i}", 1000 + i, 9) for i in range(4)]
    two = torch_s.group_peak_bytes(2, 1003, 9, 4, 3)
    groups = torch_s.plan_groups(states, 3, 2 << 30, two)
    assert [[s.chromosome for s in g] for g in groups] == [["chr0", "chr1"], ["chr2", "chr3"]]
    assert len(torch_s.plan_groups(states, 3, 2 << 30, 1 << 40)) == 1


def test_full_backtrace_equals_the_checkpointed_scan():
    """The plain sampling DP over whole [N, P] backtraces gives the path
    and score of the reference's checkpointed scan (segments of 512
    columns) and of its full scan, at N=3000, P=9: the port's sampling of
    long chromosomes in one sweep replaces the checkpointed scan
    exactly."""
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
