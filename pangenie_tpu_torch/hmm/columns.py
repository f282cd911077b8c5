"""Densification: per-bubble records -> padded per-chromosome tensors.

Replaces the reference ColumnIndexer (src/columnindexer.cpp:8-78) and
the per-column "computer" objects with dense arrays that a single
``lax.scan`` consumes:

- columns where every (selected) path carries REF or an undefined allele
  are dropped (they carry no genotyping signal),
- the path subset (``only_paths``) is fixed once for the whole scan
  (the reference asserts all columns share one path set),
- per-column kmer data is padded to the chromosome-wide max kmer count,
- log copy-number probabilities are precomputed host-side from the
  ProbabilityTable (so table overrides used by tests flow through).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from ..kmers.unique import UniqueKmersRecord
from ..model.probabilities import ProbabilityTable


@dataclass
class HMMColumns:
    """Dense inputs for one (chromosome, path-subset) HMM run.

    N kept columns, P selected paths, K max kmers per column,
    A max distinct alleles per column (among the FULL panel's paths, so
    local allele indices are comparable across path subsets).
    """

    variant_ids: np.ndarray      # [N] index into the full records list
    positions: np.ndarray        # [N] variant positions (for transitions)
    paths: np.ndarray            # [P] global path ids of this subset
    alleles: np.ndarray          # [N, P] global allele id per path
    undefined: np.ndarray        # [N, A] local allele is undefined
    kmer_counts: np.ndarray      # [N, K] read counts (padded 0)
    incidence: np.ndarray        # [N, K, A] kmer-on-(local)allele
    kmer_mask: np.ndarray        # [N, K] valid kmer
    coverage: np.ndarray         # [N] local coverage
    log_probs: np.ndarray        # [N, K, 3] log P(count | CN)
    all_zeros: np.ndarray        # [N] full-panel emission matrix all-zero
    local_alleles: np.ndarray    # [N, A] global allele ids, -1 padded
    allele_local: np.ndarray     # [N, P] local index of alleles[n, p]
    nr_local: np.ndarray         # [N] number of distinct alleles
    # optional compressed log_probs (exact): row indices + value table
    lp_idx: "np.ndarray | None" = None    # [N, K] uint16
    lp_table: "np.ndarray | None" = None  # [T, 3]

    @property
    def n_columns(self) -> int:
        return len(self.positions)

    @property
    def n_paths(self) -> int:
        return len(self.paths)


def transition_probs(
    positions: np.ndarray,
    nr_paths: int,
    recombrate: float,
    effective_N: float,
    uniform: bool = False,
) -> np.ndarray:
    """Li-Stephens pair transition probabilities per adjacent column.

    Returns [N-1, 3] = (stay*stay, stay*switch, switch*switch), using
    d = delta_pos * 4e-6 * recombrate * effective_N,
    switch = (1 - exp(-d/P))/P, stay = exp(-d/P) + switch
    (reference src/transitionprobabilitycomputer.cpp:8-19).
    """
    n = len(positions)
    if n < 2:
        return np.zeros((0, 3), dtype=np.float64)
    if uniform:
        return np.ones((n - 1, 3), dtype=np.float64)
    distance = (
        np.diff(positions.astype(np.float64)) * 0.000004 * recombrate * effective_N
    )
    recomb = (1.0 - np.exp(-distance / nr_paths)) / nr_paths
    stay = np.exp(-distance / nr_paths) + recomb
    return np.stack([stay * stay, stay * recomb, recomb * recomb], axis=1)


def _log_probability_grid(
    table: ProbabilityTable,
    coverage: np.ndarray,
    counts: np.ndarray,
    mask: np.ndarray,
    dtype=np.float64,
) -> np.ndarray:
    """Vectorized [N, K, 3] log P(count | CN) at per-column coverage.

    Gathers directly from a cached LOG table in the target dtype: log
    magnitudes stay small, so float32 keeps the exact positivity
    structure (isfinite(lp) == p > 0) that linear float32 would flush
    away — and the gather moves half the bytes of the old f64 grid.
    """
    N, K = counts.shape
    dtype = np.dtype(dtype)
    cov = coverage.astype(np.int64)
    cnt = counts.astype(np.int64)
    cov_ok = (cov >= table.cov_min) & (cov < table.cov_max)
    in_table = cov_ok[:, None] & (cnt < table.count_max) & mask
    log_table = table.log_table(dtype)
    idx = None
    value_table = None
    if log_table.size:
        # clipped direct gather + mask (avoids the boolean fancy-index
        # temporaries that dominated the densify profile)
        cov_idx = np.clip(cov - table.cov_min, 0, log_table.shape[1] - 1)
        cnt_idx = np.minimum(cnt, log_table.shape[0] - 1)
        gathered = log_table[cnt_idx, cov_idx[:, None]]  # [N, K, 3]
        out = np.where(in_table[:, :, None], gathered, -np.inf)
        out[~mask] = 0.0  # padding slots carry no (-inf) signal
    else:
        out = np.zeros((N, K, 3), dtype=dtype)
        out[in_table] = -np.inf
    oob = mask & ~in_table
    vals = np.zeros((0, 3), dtype=dtype)
    inverse = None
    if np.any(oob):
        # fall back per unique (cov, count) pair
        cov2 = np.broadcast_to(cov[:, None], (N, K))
        pairs = np.stack([cov2[oob], cnt[oob]], axis=1)
        uniq, inverse = np.unique(pairs, axis=0, return_inverse=True)
        lin = np.stack(
            [table.compute_probability(int(c), int(x)) for c, x in uniq]
        )
        with np.errstate(divide="ignore"):
            vals = np.where(lin > 0, np.log(lin), -np.inf).astype(dtype)
        out[oob] = vals[inverse]

    # COMPRESSED form of the SAME grid: every cell's 3-vector comes
    # from a small table (row 0 = the masked/padding zeros, then the
    # in-table entries, then the unique out-of-table fallbacks), so the
    # device transfer can ship uint16 indices (2 B/cell) + the table
    # instead of the 12 B/cell f32 grid. Pure exact compression — the
    # device gather reproduces `out` bit-for-bit.
    if log_table.size:
        ncnt, ncov = log_table.shape[0], log_table.shape[1]
        n_rows = 1 + ncnt * ncov + len(vals)
        if n_rows <= 0xFFFF:
            idx = np.zeros((N, K), dtype=np.uint16)
            flat = (cnt_idx * ncov + cov_idx[:, None] + 1)
            idx[in_table] = flat[in_table].astype(np.uint16)
            if inverse is not None:
                idx[oob] = (1 + ncnt * ncov + inverse).astype(np.uint16)
            value_table = np.concatenate(
                [np.zeros((1, 3), dtype=dtype),
                 log_table.reshape(ncnt * ncov, 3), vals]
            )
    return out, idx, value_table


def _compute_all_zeros(
    records: Sequence[UniqueKmersRecord],
    kept: np.ndarray,
    log_probs: np.ndarray,
    kmer_mask: np.ndarray,
) -> np.ndarray:
    """Per-column flag: full-panel emission matrix identically zero.

    (reference src/emissionprobabilitycomputer.cpp:9-29). Checked over
    ALL allele ids the record knows (including alleles introduced only
    by kmers). Exact zeros only arise from zero copy-number
    probabilities (e.g. test-injected overrides), so columns with
    all-finite log probs short-circuit.
    """
    N = len(kept)
    all_zeros = np.zeros(N, dtype=bool)
    suspicious = ~np.all(
        np.isfinite(log_probs) | ~kmer_mask[:, :, None], axis=(1, 2)
    )
    for n in np.nonzero(suspicious)[0]:
        record = records[kept[n]]
        allele_ids = record.get_allele_ids()
        col_probs = np.exp(log_probs[n].astype(np.float64))
        k_mask = kmer_mask[n]
        found_nonzero = False
        for a1 in allele_ids:
            for a2 in allele_ids:
                u1, u2 = record.is_undefined_allele(a1), record.is_undefined_allele(a2)
                value = 1.0
                for ki in range(record.size()):
                    if not k_mask[ki]:
                        continue
                    expected = int(record.kmer_on_allele(ki, a1)) + int(
                        record.kmer_on_allele(ki, a2)
                    )
                    if u1 and u2:
                        value *= (
                            col_probs[ki, 0] + col_probs[ki, 1] + col_probs[ki, 2]
                        ) / 3.0
                    elif u1 or u2:
                        expected = min(expected, 1)
                        value *= 0.5 * (
                            col_probs[ki, expected] + col_probs[ki, expected + 1]
                        )
                    else:
                        value *= col_probs[ki, expected]
                if value > 0:
                    found_nonzero = True
                    break
            if found_nonzero:
                break
        all_zeros[n] = not found_nonzero
    return all_zeros


@dataclass
class DenseRecords:
    """Chromosome-level, subset-independent densification of records.

    Built ONCE per chromosome and shared by every (path-subset) HMM run
    — kmer data, local-allele compression (over the FULL panel so local
    indices agree across subsets), copy-number probabilities and the
    all-zeros flags do not depend on the subset.
    """

    full: np.ndarray           # [R, P_full] path -> allele
    positions: np.ndarray      # [R]
    coverage: np.ndarray       # [R]
    kmer_counts: np.ndarray    # [R, K]
    kmer_mask: np.ndarray      # [R, K]
    local_alleles: np.ndarray  # [R, A] sorted, -1 padded
    nr_local: np.ndarray       # [R]
    undefined: np.ndarray      # [R, A]
    full_local: np.ndarray     # [R, P_full] local index per path allele
    incidence: np.ndarray      # [R, K, A]
    log_probs: np.ndarray      # [R, K, 3]
    all_zeros: np.ndarray      # [R]
    lp_idx: "np.ndarray | None" = None    # [R, K] uint16
    lp_table: "np.ndarray | None" = None  # [T, 3]

    @property
    def n_records(self) -> int:
        return len(self.positions)


def _ranks_in_sorted_rows(
    local_alleles: np.ndarray, alleles: np.ndarray
) -> np.ndarray:
    """Per row: index of each allele in the row's sorted locals list
    (= count of valid locals strictly below it). Blocked to bound the
    [blk, P, A] temporary."""
    N, P = alleles.shape
    A = local_alleles.shape[1]
    out = np.empty((N, P), dtype=np.int32)
    blk = max(1, (1 << 24) // max(1, P * A))
    for start in range(0, N, blk):
        sl = slice(start, min(N, start + blk))
        la = local_alleles[sl]
        out[sl] = (
            (la[:, None, :] >= 0) & (la[:, None, :] < alleles[sl][:, :, None])
        ).sum(axis=2, dtype=np.int32)
    return out


def densify_records(
    records: Sequence[UniqueKmersRecord],
    probabilities: ProbabilityTable,
    dtype=np.float64,
) -> DenseRecords:
    """Bulk numpy densification over the records' array internals.

    The per-column Python loops this replaces were the genome-scale
    host wall (the reference does the equivalent work inside its C++
    thread pool, src/commands.cpp:76-152). ``dtype`` is the HMM device
    dtype: the log-probability grid is built directly in it (float32 on
    TPU halves the densify bytes and the host->device transfer).
    """
    if not records:
        raise RuntimeError("densify_records: no variant records.")
    R = len(records)
    nr_total_paths = records[0].get_nr_paths()

    # full-panel allele matrix [R, P_full] (uniform path count, as the
    # reference's ColumnIndexer assumes; src/columnindexer.cpp:7)
    full = np.empty((R, nr_total_paths), dtype=np.int32)
    for i, record in enumerate(records):
        row = record.path_to_allele
        if len(row) != nr_total_paths:
            if len(row) == 0:
                raise RuntimeError(
                    f"build_columns: column {i} is not covered by any paths."
                )
            raise RuntimeError(
                "build_columns: records disagree on the number of paths "
                f"({len(row)} != {nr_total_paths} at column {i})."
            )
        full[i] = row

    positions = np.fromiter(
        (r.variant_position for r in records), dtype=np.int64, count=R
    )
    coverage = np.fromiter(
        (r.coverage for r in records), dtype=np.int32, count=R
    )
    sizes = np.fromiter((r.size() for r in records), dtype=np.int64, count=R)
    K = max(1, int(sizes.max()))

    # dense kmer counts via flat CSR scatter
    total_k = int(sizes.sum())
    kmer_counts = np.zeros((R, K), dtype=np.int32)
    kmer_mask = np.zeros((R, K), dtype=bool)
    if total_k:
        flat_counts = np.concatenate(
            [r.kmer_counts for r in records if r.size()]
        )
        rowk = np.repeat(np.arange(R, dtype=np.int64), sizes)
        offsets = np.cumsum(sizes) - sizes
        colk = np.arange(total_k, dtype=np.int64) - np.repeat(offsets, sizes)
        kmer_counts[rowk, colk] = flat_counts
        kmer_mask[rowk, colk] = True

    # local allele compression over the FULL panel's allele set
    srt = np.sort(full, axis=1)
    is_new = np.ones_like(srt, dtype=bool)
    if nr_total_paths > 1:
        is_new[:, 1:] = srt[:, 1:] != srt[:, :-1]
    nr_local = is_new.sum(axis=1).astype(np.int32)
    A = max(1, int(nr_local.max()))
    local_alleles = np.full((R, A), -1, dtype=np.int32)
    rank = np.cumsum(is_new, axis=1) - 1
    new_rows, _ = np.nonzero(is_new)
    local_alleles[new_rows, rank[is_new]] = srt[is_new]

    full_local = _ranks_in_sorted_rows(local_alleles, full)

    # undefined flags: rare — only visit rows that have any
    undefined = np.zeros((R, A), dtype=bool)
    has_undef = np.fromiter(
        (r.has_undefined_alleles() for r in records), dtype=bool, count=R
    )
    for n in np.nonzero(has_undef)[0]:
        record = records[n]
        for li in range(int(nr_local[n])):
            undefined[n, li] = record.is_undefined_allele(
                int(local_alleles[n, li])
            )

    # kmer->local-allele incidence via the records' CSR arrays
    incidence = np.zeros((R, K, A), dtype=bool)
    if total_k:
        all_single = all(r.all_single_allele() for r in records)
        if all_single:
            flat_allele = np.concatenate(
                [r.allele_data for r in records if r.size()]
            )
            rows_e, cols_e = rowk, colk
        else:
            flat_allele = np.concatenate(
                [r.allele_data for r in records if len(r.allele_data)]
            )
            per_kmer_lens = np.concatenate(
                [np.diff(r.allele_indptr) for r in records if r.size()]
            )
            rows_e = np.repeat(rowk, per_kmer_lens)
            cols_e = np.repeat(colk, per_kmer_lens)
        E = len(flat_allele)
        eblk = max(1, (1 << 25) // max(1, A))
        for start in range(0, E, eblk):
            sl = slice(start, min(E, start + eblk))
            eq = local_alleles[rows_e[sl]] == flat_allele[sl, None]
            present = eq.any(axis=1)
            li = eq.argmax(axis=1)
            incidence[
                rows_e[sl][present], cols_e[sl][present], li[present]
            ] = True

    log_probs, lp_idx, lp_table = _log_probability_grid(
        probabilities, coverage, kmer_counts, kmer_mask, dtype
    )
    all_zeros = _compute_all_zeros(
        records, np.arange(R, dtype=np.int64), log_probs, kmer_mask
    )

    return DenseRecords(
        full=full,
        positions=positions,
        coverage=coverage,
        kmer_counts=kmer_counts,
        kmer_mask=kmer_mask,
        local_alleles=local_alleles,
        nr_local=nr_local,
        undefined=undefined,
        full_local=full_local,
        incidence=incidence,
        log_probs=log_probs,
        all_zeros=all_zeros,
        lp_idx=lp_idx,
        lp_table=lp_table,
    )


def build_columns(
    records: Sequence[UniqueKmersRecord],
    probabilities: ProbabilityTable,
    only_paths: Optional[Sequence[int]] = None,
    dense: Optional[DenseRecords] = None,
    dtype=np.float64,
) -> HMMColumns:
    """Dense HMM inputs for one (chromosome, path-subset) run.

    With ``dense`` given (built once per chromosome via
    :func:`densify_records`), the per-subset work is only row filtering
    and path-column slicing — all vectorized.
    """
    if not records:
        raise RuntimeError("build_columns: no variant records.")
    if dense is None:
        dense = densify_records(records, probabilities, dtype)

    nr_total_paths = dense.full.shape[1]
    if only_paths is not None:
        paths = [p for p in only_paths if p < nr_total_paths]
    else:
        paths = list(range(nr_total_paths))
    if len(paths) == 0:
        raise RuntimeError("build_columns: column is not covered by any paths.")
    paths_arr = np.array(paths, dtype=np.int32)
    P = len(paths)

    sub_all = dense.full[:, paths_arr]          # [R, P]
    sub_local = dense.full_local[:, paths_arr]  # [R, P]

    # keep columns where some selected path carries a non-REF, defined
    # allele (src/columnindexer.cpp:24-31)
    path_undef = np.take_along_axis(dense.undefined, sub_local, axis=1)
    keep_mask = ((sub_all != 0) & ~path_undef).any(axis=1)
    kept_arr = np.nonzero(keep_mask)[0].astype(np.int64)
    N = len(kept_arr)
    if N == 0:
        K = 1
        return HMMColumns(
            variant_ids=kept_arr,
            positions=np.zeros(0, dtype=np.int64),
            paths=paths_arr,
            alleles=np.zeros((0, P), dtype=np.int32),
            undefined=np.zeros((0, 1), dtype=bool),
            kmer_counts=np.zeros((0, K), dtype=np.int32),
            incidence=np.zeros((0, K, 1), dtype=bool),
            kmer_mask=np.zeros((0, K), dtype=bool),
            coverage=np.zeros(0, dtype=np.int32),
            log_probs=np.zeros((0, K, 3), dtype=dense.log_probs.dtype),
            all_zeros=np.zeros(0, dtype=bool),
            local_alleles=np.full((0, 1), -1, dtype=np.int32),
            allele_local=np.zeros((0, P), dtype=np.int32),
            nr_local=np.zeros(0, dtype=np.int32),
        )

    return HMMColumns(
        variant_ids=kept_arr,
        positions=dense.positions[kept_arr],
        paths=paths_arr,
        alleles=sub_all[kept_arr],
        undefined=dense.undefined[kept_arr],
        kmer_counts=dense.kmer_counts[kept_arr],
        incidence=dense.incidence[kept_arr],
        kmer_mask=dense.kmer_mask[kept_arr],
        coverage=dense.coverage[kept_arr],
        log_probs=dense.log_probs[kept_arr],
        all_zeros=dense.all_zeros[kept_arr],
        local_alleles=dense.local_alleles[kept_arr],
        allele_local=sub_local[kept_arr],
        nr_local=dense.nr_local[kept_arr],
        lp_idx=(
            dense.lp_idx[kept_arr] if dense.lp_idx is not None else None
        ),
        lp_table=dense.lp_table,
    )
