"""Synthetic workload generation for benchmarks and compile checks.

Produces device-ready :class:`ColumnArrays` with the statistics of a
real genotyping run (Poisson kmer counts at a given coverage, panel
path->allele maps, Li-Stephens transitions) without any input files.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..hmm.columns import transition_probs
from ..hmm.forward_backward import ColumnArrays
from ..model.probabilities import ProbabilityTable


def synthetic_columns(
    n_columns: int = 256,
    n_paths: int = 16,
    n_kmers: int = 16,
    n_alleles: int = 2,
    coverage: int = 30,
    batch_dims: Tuple[int, ...] = (),
    seed: int = 0,
    dtype=np.float64,
) -> ColumnArrays:
    """Build ColumnArrays of shape [*batch_dims, N, ...].

    Alleles are drawn uniformly per (column, path); kmer counts are
    Poisson at cn=1 coverage; every column gets K valid kmers spread
    round-robin over alleles.
    """
    rng = np.random.default_rng(seed)
    shape = tuple(batch_dims)
    N, P, K, A = n_columns, n_paths, n_kmers, n_alleles

    table = ProbabilityTable(coverage // 4, coverage * 4, 2 * coverage, 0.01)

    alleles = rng.integers(0, A, size=shape + (N, P)).astype(np.int32)
    # ensure allele 0 and 1 both appear (non-degenerate columns)
    alleles[..., 0] = 0
    alleles[..., 1] = 1
    undefined = np.zeros(shape + (N, A), dtype=bool)
    kmer_alleles = np.arange(K, dtype=np.int32) % A  # [K]
    incidence = np.zeros(shape + (N, K, A), dtype=bool)
    incidence[..., np.arange(K), kmer_alleles] = True
    kmer_mask = np.ones(shape + (N, K), dtype=bool)
    counts = rng.poisson(coverage / 2.0, size=shape + (N, K)).astype(np.int64)
    counts = np.minimum(counts, 2 * coverage - 1)

    # probability lookup: all in-table by construction
    pr = table.table[counts, coverage - table.cov_min].astype(dtype)
    with np.errstate(divide="ignore"):
        lp = np.where(pr > 0, np.log(np.maximum(pr, 1e-300)), -np.inf).astype(dtype)

    positions = np.cumsum(
        rng.integers(50, 2000, size=shape + (N,)), axis=-1
    ).astype(np.int64)
    trans = np.ones(shape + (N, 3), dtype=dtype)
    flat_pos = positions.reshape(-1, N)
    flat_trans = trans.reshape(-1, N, 3)
    for i in range(flat_pos.shape[0]):
        flat_trans[i, 1:] = transition_probs(flat_pos[i], P, 1.26, 25000.0)

    scale = np.sum(np.max(lp, axis=-1) * kmer_mask, axis=-1).astype(dtype)
    allele_local = alleles.copy()  # identity: global allele ids are 0..A-1
    nr_local = np.full(shape + (N,), A, dtype=np.int32)

    is_last = np.zeros(shape + (N,), dtype=bool)
    is_last[..., N - 1] = True

    return ColumnArrays(
        lp=lp,
        incidence=incidence,
        kmer_mask=kmer_mask,
        alleles=alleles,
        undefined=undefined,
        all_zeros=np.zeros(shape + (N,), dtype=bool),
        scale=scale,
        trans=trans,
        allele_local=allele_local,
        nr_local=nr_local,
        is_last=is_last,
    )
