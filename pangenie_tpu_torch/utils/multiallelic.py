"""Synthetic multi-allelic columns whose posteriors stay in float32 range.

:func:`synthetic_columns` spreads k-mers round-robin over all A alleles
and draws every k-mer's read count at copy number 1, so at A=16 each
path pair lacks most k-mers and its emission is about e^-67: the raw
posteriors (about the product of two neighbouring emissions) underflow
in float32. Here each column keeps its own allele count (``allele_caps``)
with its k-mers only on alleles it has, and the read counts follow a
true path pair drawn per column, so the true pair's emission is O(1)
and a kernel's raw posteriors can be held against a plain version's at
a sound scale.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..hmm.forward_backward import ColumnArrays
from ..model.probabilities import ProbabilityTable
from .synthetic import synthetic_columns


def allele_mix(n_columns: int, seed: int,
               mix=((0.97, 2), (0.02, 4), (0.01, 16))) -> np.ndarray:
    """Per-column allele counts drawn from ``mix`` ((share, count), ...);
    the default is the 97/2/1% profile of a real chromosome
    (benchmarks/bench_sv_sampling.py:122-165)."""
    draw = np.random.default_rng(seed).random(n_columns)
    edges = np.cumsum([share for share, _ in mix])
    counts = np.array([count for _, count in mix], dtype=np.int32)
    return counts[np.minimum(np.searchsorted(edges, draw, side="right"),
                             len(counts) - 1)]


def multiallelic_columns(
    n_columns: int,
    n_paths: int,
    n_kmers: int,
    allele_caps: np.ndarray,
    coverage: int = 30,
    batch_dims: Tuple[int, ...] = (),
    seed: int = 0,
    dtype=np.float32,
) -> ColumnArrays:
    """ColumnArrays [*batch_dims, N, ...] with A = max(allele_caps).

    Column n has ``allele_caps[n]`` alleles (paths 0 and 1 carry alleles
    0 and 1); k-mer k sits on allele (k % A) % allele_caps[n]; its read
    count is Poisson at ``coverage / 2`` times its copy number in a true
    path pair drawn per column.
    """
    caps = np.asarray(allele_caps, dtype=np.int32)
    N, P, K, A = n_columns, n_paths, n_kmers, int(caps.max())
    shape = tuple(batch_dims)
    base = synthetic_columns(n_columns=N, n_paths=P, n_kmers=K, n_alleles=A,
                             coverage=coverage, batch_dims=shape, seed=seed,
                             dtype=dtype)
    rng = np.random.default_rng(seed + 1)
    alleles = (base.alleles % caps[:, None]).astype(np.int32)          # [..., N, P]
    kmer_alleles = (np.arange(K) % A)[None, :] % caps[:, None]         # [N, K]
    incidence = np.broadcast_to(
        kmer_alleles[:, :, None] == np.arange(A), shape + (N, K, A)).copy()
    truth = np.take_along_axis(alleles, rng.integers(0, P, shape + (N, 2)), axis=-1)
    copies = ((kmer_alleles == truth[..., :1]).astype(np.int64)
              + (kmer_alleles == truth[..., 1:]))                       # [..., N, K]
    counts = np.minimum(rng.poisson(coverage / 2.0 * copies), 2 * coverage - 1)
    table = ProbabilityTable(coverage // 4, coverage * 4, 2 * coverage, 0.01)
    pr = table.table[counts, coverage - table.cov_min].astype(dtype)
    with np.errstate(divide="ignore"):
        lp = np.where(pr > 0, np.log(np.maximum(pr, 1e-300)), -np.inf).astype(dtype)
    return base._replace(
        lp=lp,
        incidence=incidence,
        alleles=alleles,
        allele_local=alleles.copy(),
        nr_local=np.broadcast_to(caps, shape + (N,)).copy(),
        scale=np.sum(np.max(lp, axis=-1), axis=-1).astype(dtype),
    )
