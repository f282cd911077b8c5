"""Per-bubble unique-kmer records and the selection pipeline.

Replaces the reference's UniqueKmers hierarchy
(src/uniquekmers.hpp, src/biallelicuniquekmers.cpp,
src/multiallelicuniquekmers.cpp) with ONE host-side record — the
biallelic/multiallelic split in the reference is a bit-packing detail
(KmerPath16 vs KmerPath); here kmer->allele incidence is a small list
per kmer, and the HMM layer densifies records into padded tensors.

Also hosts the two selection drivers:

- :class:`UniqueKmerComputer` (genotype-time, with read counts;
  reference src/uniquekmercomputer.cpp:95-253)
- :class:`StepwiseUniqueKmerComputer` (index-time, counts filled later;
  reference src/stepwiseuniquekmercomputer.cpp:96-265)
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..model.probabilities import ProbabilityTable
from ..panel.graph import ChromosomeGraph
from .counter import KmerCounter
from .mer import decode_kmer


class UniqueKmersRecord:
    """Unique-kmer state of one variant bubble.

    Internals are dense numpy arrays (not Python lists) so that
    per-chromosome densification (`hmm.columns.build_columns`) and the
    sampling-HMM cost build run as bulk array ops over millions of
    records — the reference gets this for free in C++
    (src/commands.cpp:76-152); a Python object graph does not.

    - ``path_to_allele``: int32 [P]
    - ``kmer_counts``: int32 [K]
    - kmer -> allele incidence as CSR: ``allele_data`` int32 +
      ``allele_indptr`` int32 [K+1] (alleles sorted unique per kmer)
    """

    __slots__ = (
        "variant_position",
        "coverage",
        "path_to_allele",
        "_kmer_counts",
        "allele_data",
        "allele_indptr",
        "alleles",
    )

    def __init__(
        self,
        variant_position: int,
        path_to_allele: Sequence[int],
        covered: Optional[Sequence[int]] = None,
    ):
        self.variant_position = int(variant_position)
        self.path_to_allele = np.asarray(path_to_allele, dtype=np.int32)
        self.coverage = 0
        self._kmer_counts = np.empty(0, dtype=np.int32)
        self.allele_data = np.empty(0, dtype=np.int32)
        self.allele_indptr = np.zeros(1, dtype=np.int32)
        # allele id -> is_undefined; key set = alleles covered by paths
        # (+ any alleles later introduced by insert_kmer, mirroring the
        # reference's operator[] behaviour). ``covered`` lets bulk
        # callers pass the precomputed unique path-allele set (the
        # per-record np.unique was a selection-header hot spot).
        self.alleles: Dict[int, bool] = dict.fromkeys(
            np.unique(self.path_to_allele).tolist()
            if covered is None
            else covered,
            False,
        )

    # -- list-compat views (tests mutate these directly) -----------------

    @property
    def kmer_counts(self) -> np.ndarray:
        return self._kmer_counts

    @kmer_counts.setter
    def kmer_counts(self, counts) -> None:
        self._kmer_counts = np.asarray(counts, dtype=np.int32)

    @property
    def kmer_alleles(self) -> List[List[int]]:
        ptr = self.allele_indptr
        return [
            self.allele_data[ptr[i] : ptr[i + 1]].tolist()
            for i in range(len(ptr) - 1)
        ]

    @kmer_alleles.setter
    def kmer_alleles(self, lists: Sequence[Sequence[int]]) -> None:
        data: List[int] = []
        indptr = [0]
        for ids in lists:
            data.extend(sorted(set(int(a) for a in ids)))
            indptr.append(len(data))
        self.allele_data = np.asarray(data, dtype=np.int32)
        self.allele_indptr = np.asarray(indptr, dtype=np.int32)
        for a in data:
            self.alleles.setdefault(a, False)

    # -- mutation --------------------------------------------------------

    def insert_kmer(self, readcount: int, allele_ids: Sequence[int]) -> None:
        ids = np.unique(np.asarray(allele_ids, dtype=np.int32))
        self._kmer_counts = np.append(self._kmer_counts, np.int32(readcount))
        self.allele_data = np.concatenate([self.allele_data, ids])
        self.allele_indptr = np.append(
            self.allele_indptr, self.allele_indptr[-1] + np.int32(len(ids))
        )
        for a in ids.tolist():
            self.alleles.setdefault(a, False)

    def insert_kmers_single(
        self, readcounts: np.ndarray, allele_ids: np.ndarray
    ) -> None:
        """Bulk insert of kmers lying on exactly one allele each (the
        production selection invariant; src/uniquekmercomputer.cpp:45-92
        keeps only single-allele kmers)."""
        counts = np.asarray(readcounts, dtype=np.int32)
        ids = np.asarray(allele_ids, dtype=np.int32)
        assert len(counts) == len(ids)
        if not len(ids):
            return
        self._kmer_counts = np.concatenate([self._kmer_counts, counts])
        self.allele_data = np.concatenate([self.allele_data, ids])
        self.allele_indptr = np.concatenate(
            [
                self.allele_indptr,
                self.allele_indptr[-1]
                + np.arange(1, len(ids) + 1, dtype=np.int32),
            ]
        )
        for a in np.unique(ids).tolist():
            self.alleles.setdefault(a, False)

    def update_readcount(self, kmer_index: int, new_count: int) -> None:
        if kmer_index >= len(self._kmer_counts):
            raise RuntimeError(
                f"UniqueKmersRecord.update_readcount: kmer index {kmer_index} "
                "does not exist."
            )
        self._kmer_counts[kmer_index] = new_count

    def set_readcounts(self, counts: np.ndarray) -> None:
        """Bulk readcount fill (genotype-time TSV fill-in)."""
        counts = np.asarray(counts)
        if len(counts) != len(self._kmer_counts):
            raise RuntimeError(
                "UniqueKmersRecord.set_readcounts: size mismatch "
                f"({len(counts)} != {len(self._kmer_counts)})."
            )
        self._kmer_counts = counts.astype(np.int32)

    def set_coverage(self, coverage: int) -> None:
        self.coverage = int(coverage)

    def set_undefined_allele(self, allele_id: int) -> None:
        if allele_id not in self.alleles:
            raise RuntimeError(
                f"UniqueKmersRecord.set_undefined_allele: allele_id {allele_id} "
                "does not exist."
            )
        self.alleles[allele_id] = True

    # -- queries ---------------------------------------------------------

    def size(self) -> int:
        return len(self._kmer_counts)

    def get_variant_position(self) -> int:
        return self.variant_position

    def get_coverage(self) -> int:
        return self.coverage

    def get_nr_paths(self) -> int:
        return len(self.path_to_allele)

    def get_allele(self, path_id: int) -> int:
        return int(self.path_to_allele[path_id])

    def get_readcount_of(self, kmer_index: int) -> int:
        return int(self._kmer_counts[kmer_index])

    def all_single_allele(self) -> bool:
        """True when every kmer lies on exactly one allele (production
        invariant; the general case only arises in hand-built tests)."""
        return len(self.allele_data) == len(self._kmer_counts)

    def kmer_on_allele(self, kmer_index: int, allele_id: int) -> bool:
        ptr = self.allele_indptr
        seg = self.allele_data[ptr[kmer_index] : ptr[kmer_index + 1]]
        return bool((seg == allele_id).any())

    def kmer_on_path(self, kmer_index: int, path_id: int) -> bool:
        return self.kmer_on_allele(kmer_index, int(self.path_to_allele[path_id]))

    def get_path_ids(
        self, only_include: Optional[Sequence[int]] = None
    ) -> Tuple[List[int], List[int]]:
        """(paths, alleles); restricted to only_include when given.

        (reference src/biallelicuniquekmers.cpp:95-112)
        """
        if only_include is not None:
            nr = len(self.path_to_allele)
            paths = [p for p in only_include if p < nr]
            if not paths:
                return [], []
            alleles = self.path_to_allele[np.asarray(paths, dtype=np.int64)]
            return paths, alleles.tolist()
        return (
            list(range(len(self.path_to_allele))),
            self.path_to_allele.tolist(),
        )

    def get_allele_ids(self) -> List[int]:
        return sorted(self.alleles.keys())

    def get_defined_allele_ids(self) -> List[int]:
        return sorted(a for a, undef in self.alleles.items() if not undef)

    def is_undefined_allele(self, allele_id: int) -> bool:
        return self.alleles.get(allele_id, False)

    def has_undefined_alleles(self) -> bool:
        return any(self.alleles.values())

    def kmers_on_allele(self, allele_id: int) -> int:
        return int(np.count_nonzero(self.allele_data == allele_id))

    def kmers_on_alleles(self) -> Dict[int, int]:
        return {a: self.kmers_on_allele(a) for a in self.alleles}

    def present_kmers_on_allele(self, allele_id: int) -> int:
        """Kmers on the allele with read support (count >= 3).

        (reference src/biallelicuniquekmers.cpp:170-180)
        """
        lens = np.diff(self.allele_indptr)
        present = np.repeat(self._kmer_counts >= 3, lens)
        return int(np.count_nonzero((self.allele_data == allele_id) & present))

    def fraction_present_kmers_on_allele(self, allele_id: int) -> float:
        total = self.kmers_on_allele(allele_id)
        if total > 0:
            return np.float32(self.present_kmers_on_allele(allele_id)) / np.float32(
                total
            )
        return 1.0

    # -- panel subsetting ------------------------------------------------

    def update_paths(self, path_ids: Sequence[int]) -> None:
        """Restrict to the given paths (haplotype-sampling output).

        Kmers whose alleles are no longer covered are dropped and the
        remaining kmers renumbered in old-index order; surviving kmers
        keep their alleles in sorted order
        (reference src/biallelicuniquekmers.cpp:223-260).
        """
        ids = np.asarray(path_ids, dtype=np.int64)
        new_p2a = (
            self.path_to_allele[ids].astype(np.int32)
            if len(ids)
            else np.empty(0, dtype=np.int32)
        )
        surviving = np.unique(new_p2a)
        undefined = [
            a for a in surviving.tolist() if self.alleles.get(a, False)
        ]

        lens = np.diff(self.allele_indptr)
        kmer_idx = np.repeat(
            np.arange(len(lens), dtype=np.int64), lens
        )
        keep = np.isin(self.allele_data, surviving)
        kept_kmer = kmer_idx[keep]
        kept_allele = self.allele_data[keep]
        # alleles already sorted within each kmer; kmer order preserved
        old_ids, new_lens = np.unique(kept_kmer, return_counts=True)

        self.path_to_allele = new_p2a
        self.alleles = dict.fromkeys(surviving.tolist(), False)
        for a in undefined:
            self.alleles[a] = True
        self._kmer_counts = self._kmer_counts[old_ids]
        self.allele_data = kept_allele
        self.allele_indptr = np.concatenate(
            [np.zeros(1, dtype=np.int64), np.cumsum(new_lens)]
        ).astype(np.int32)


def bulk_update_paths(
    records: Sequence[UniqueKmersRecord], sampled: np.ndarray
) -> None:
    """Vectorized :meth:`UniqueKmersRecord.update_paths` over a whole
    chromosome (sampled: [S, N] path ids per record).

    Requires every record's kmers to lie on a single allele (the
    production selection invariant); falls back to the per-record path
    otherwise. The per-record numpy pipeline (~100 us each) was the
    genome-scale wall of the sampling phase.
    """
    S, N = sampled.shape
    if N == 0:
        return
    assert len(records) == N
    sizes = np.fromiter((r.size() for r in records), np.int64, count=N)
    lens = np.fromiter(
        (len(r.allele_data) for r in records), np.int64, count=N
    )
    if not np.array_equal(sizes, lens):
        for n, record in enumerate(records):
            record.update_paths(sampled[:, n])
        return

    P = records[0].get_nr_paths()
    p2a = np.empty((N, P), np.int32)
    for n, r in enumerate(records):
        p2a[n] = r.path_to_allele
    new_p2a = np.take_along_axis(
        p2a, sampled.T.astype(np.int64), axis=1
    ).astype(np.int32)
    surv_sorted = np.sort(new_p2a, axis=1)
    first = np.ones((N, S), bool)
    first[:, 1:] = surv_sorted[:, 1:] != surv_sorted[:, :-1]
    rows = np.repeat(
        np.arange(N, dtype=np.int64), first.sum(axis=1)
    )
    surv_keys = (rows << np.int64(20)) | surv_sorted[first].astype(np.int64)

    total = int(lens.sum())
    if total:
        flat_allele = np.concatenate(
            [r.allele_data for r in records if len(r.allele_data)]
        ).astype(np.int64)
        entry_rec = np.repeat(np.arange(N, dtype=np.int64), lens)
        keep = np.isin(
            (entry_rec << np.int64(20)) | flat_allele, surv_keys
        )
        kept_rec = entry_rec[keep]
        kept_allele = flat_allele[keep].astype(np.int32)
        counts_flat = np.concatenate(
            [r.kmer_counts for r in records if r.size()]
        )
        kept_counts = counts_flat[keep]
        off = np.searchsorted(kept_rec, np.arange(N + 1))
    else:
        kept_allele = np.empty(0, np.int32)
        kept_counts = np.empty(0, np.int32)
        off = np.zeros(N + 1, np.int64)

    boundaries = np.cumsum(first.sum(axis=1))
    flat_surv = surv_sorted[first].tolist()
    lo_s = 0
    for n, record in enumerate(records):
        hi_s = int(boundaries[n])
        old = record.alleles
        record.alleles = {
            a: old.get(a, False) for a in flat_surv[lo_s:hi_s]
        }
        lo_s = hi_s
        record.path_to_allele = new_p2a[n]
        lo, hi = int(off[n]), int(off[n + 1])
        record._kmer_counts = kept_counts[lo:hi]
        record.allele_data = kept_allele[lo:hi]
        record.allele_indptr = np.arange(hi - lo + 1, dtype=np.int32)


# ---------------------------------------------------------------------------
# selection
# ---------------------------------------------------------------------------

_ALLELE_BITS = 18  # allele ids < 2^17 (65534 + 2*samples)


def _prepare_block(graph, hdr, block_start: int, V: int, stepwise: bool):
    """Shared per-block header assembly for both selection drivers.

    Builds the block's records (with precomputed covered-allele sets),
    collects defined allele sequences + flank overhang slices, and
    returns the bulk cap/key arrays the flat pipeline consumes.
    """
    block_end = block_start + V
    records: List[UniqueKmersRecord] = []
    seg_seqs: List[bytes] = []
    seg_var_l: List[int] = []
    seg_allele_l: List[int] = []
    flank_seqs: List[bytes] = []
    chrom_seq = hdr.chrom_seq
    max_kmers = np.where(
        hdr.is_biallelic[block_start:block_end], 16, 32
    ).astype(np.int64)
    max_total = np.full(V, max(hdr.paths.shape[1], 301), np.int64)
    starts_l = hdr.starts[block_start:block_end].tolist()
    ends_l = hdr.ends[block_start:block_end].tolist()
    left_lo_l = hdr.left_lo[block_start:block_end].tolist()
    right_hi_l = hdr.right_hi[block_start:block_end].tolist()
    cov_ptr = hdr.covered_indptr
    cov_lo, cov_hi = int(cov_ptr[block_start]), int(cov_ptr[block_end])
    cov_counts = np.diff(cov_ptr[block_start:block_end + 1])
    covered_keys = hdr.covered_data[cov_lo:cov_hi] + (
        np.repeat(np.arange(V, dtype=np.int64), cov_counts) << _ALLELE_BITS
    )
    covered_flat = hdr.covered_data[cov_lo:cov_hi].tolist()
    cov_off = (cov_ptr[block_start:block_end + 1] - cov_lo).tolist()
    paths_block = hdr.paths[block_start:block_end]
    for j in range(V):
        variant = graph.get_variant(block_start + j)
        record = UniqueKmersRecord(
            starts_l[j], paths_block[j],
            covered=covered_flat[cov_off[j]:cov_off[j + 1]],
        )
        if stepwise:
            record.set_coverage(0)
        records.append(record)
        seqs, undefs = variant.selection_alleles()
        for a, u in enumerate(undefs):
            if u:
                record.set_undefined_allele(a)
            else:
                seg_seqs.append(seqs[a])
                seg_var_l.append(j)
                seg_allele_l.append(a)
        flank_seqs.append(chrom_seq[left_lo_l[j]:starts_l[j]])
        flank_seqs.append(chrom_seq[ends_l[j]:right_hi_l[j]])
    return (
        records, seg_seqs,
        np.asarray(seg_var_l, np.int64), np.asarray(seg_allele_l, np.int64),
        flank_seqs, max_kmers, max_total, covered_keys,
    )


def _select_block_kmers(
    seg_seqs, seg_var, seg_allele, covered_keys, max_kmers, max_total,
    V: int, k: int, genomic_kmers,
):
    """Flat unique-kmer selection over one block (both drivers).

    A kmer survives iff unique within its allele, local to exactly one
    allele of its bubble, genome-wide unique, and its allele is covered
    by >= 1 path; the round-robin caps (<=16/32 per allele,
    <= max(P, 301) per bubble) are applied by rank. Returns
    (fv, fa, fk): variant / allele / kmer arrays grouped by (variant,
    allele), kmers in pick (== lexicographic) order — exactly
    src/uniquekmercomputer.cpp:45-92's output order.
    """
    from .mer import flat_segment_kmers

    empty = (
        np.empty(0, np.int64), np.empty(0, np.int64),
        np.empty(0, np.uint64),
    )
    if not len(seg_seqs):
        return empty
    kmers, segs = flat_segment_kmers(seg_seqs, k)
    segs = segs.astype(np.int64)
    sk, ss = _sort_within_groups(kmers, segs, len(seg_seqs))
    new = np.ones(len(sk), bool)
    if len(sk) > 1:
        new[1:] = (ss[1:] != ss[:-1]) | (sk[1:] != sk[:-1])
    starts = np.flatnonzero(new)
    run_len = np.diff(np.append(starts, len(sk)))
    uniq_rows = starts[run_len == 1]  # unique within allele
    u_seg = ss[uniq_rows]
    u_kmer = sk[uniq_rows]
    u_var = seg_var[u_seg]
    u_allele = seg_allele[u_seg]
    # local_count == 1: kmer unique-within exactly one allele. u_var is
    # non-decreasing, so the (kmer, var) lexsort is a stable
    # per-variant kmer sort carrying the allele along (2k <= 62 bits
    # fits int64)
    vk_key, va_pay = _stable_kv_sort_within_groups(
        u_kmer.astype(np.int64), u_allele.astype(np.uint64), u_var, V
    )
    vv = u_var
    vk = vk_key.astype(np.uint64)
    va = va_pay.astype(np.int64)
    new2 = np.ones(len(vk), bool)
    if len(vk) > 1:
        new2[1:] = (vv[1:] != vv[:-1]) | (vk[1:] != vk[:-1])
    starts2 = np.flatnonzero(new2)
    rl2 = np.diff(np.append(starts2, len(vk)))
    rows = starts2[rl2 == 1]
    cand_var = vv[rows]
    cand_kmer = vk[rows]
    cand_allele = va[rows]
    if not len(cand_var):
        return empty
    # allele must be covered by >= 1 path; genome-wide count == 1
    cand_keys = (cand_var << _ALLELE_BITS) + cand_allele
    cov_ok = np.isin(cand_keys, covered_keys)
    gen = genomic_kmers.get_abundances(cand_kmer)
    m = cov_ok & (gen == 1)
    v3 = cand_var[m]
    a3 = cand_allele[m]
    k3 = cand_kmer[m]
    # per-allele cap: rank within (var, allele), kmers in lexicographic
    # order. Input is sorted by (var, kmer), so a stable per-variant
    # sort by allele yields (var, allele, kmer) order
    a3, k3 = _stable_kv_sort_within_groups(a3, k3, v3, V)
    n3 = len(v3)
    if not n3:
        return empty
    new3 = np.ones(n3, bool)
    new3[1:] = (v3[1:] != v3[:-1]) | (a3[1:] != a3[:-1])
    grp = np.maximum.accumulate(np.where(new3, np.arange(n3), 0))
    rank = np.arange(n3) - grp
    keep3 = rank < max_kmers[v3]
    v4, a4, k4, r4 = v3[keep3], a3[keep3], k3[keep3], rank[keep3]
    # round-robin total cap: global pick order is (rank, allele)
    # within each variant — one stable per-variant sort on
    # (rank << 18) | allele
    key4, k5 = _stable_kv_sort_within_groups(
        (r4 << _ALLELE_BITS) | a4, k4, v4, V
    )
    v5 = v4
    a5 = key4 & ((1 << _ALLELE_BITS) - 1)
    n5 = len(v5)
    new5 = np.ones(n5, bool)
    if n5:
        new5[1:] = v5[1:] != v5[:-1]
    var_start = np.maximum.accumulate(np.where(new5, np.arange(n5), 0))
    pos = np.arange(n5) - var_start
    keep5 = pos < max_total[v5]
    v6, a6, k6 = v5[keep5], a5[keep5], k5[keep5]
    # final layout: grouped by allele, kmers in pick (== lexicographic)
    # order — within (var, allele) entries already ascend by kmer
    # (rank order), so one more stable allele sort
    fa, fk = _stable_kv_sort_within_groups(a6, k6, v6, V)
    return v6, fa, fk


def _unique_flank_kmers(flank_seqs, k: int, genomic_kmers):
    """Per-flank genome-unique kmers with the <=12-per-side rank cap.

    Returns (segF, kmF, genF, chosen): the per-flank unique kmers in
    sorted order, their genome-wide counts, and the mask selecting the
    first <=12 genome-unique kmers of each flank (reference
    src/uniquekmercomputer.cpp:195-253 /
    src/stepwiseuniquekmercomputer.cpp:227-265).
    """
    from .mer import flat_segment_kmers

    fkm, fsg = flat_segment_kmers(flank_seqs, k)
    fsg = fsg.astype(np.int64)
    fkm, fsg = _sort_within_groups(fkm, fsg, len(flank_seqs))
    newF = np.ones(len(fkm), bool)
    if len(fkm) > 1:
        newF[1:] = (fsg[1:] != fsg[:-1]) | (fkm[1:] != fkm[:-1])
    startsF = np.flatnonzero(newF)
    rlF = np.diff(np.append(startsF, len(fkm)))
    rowsF = startsF[rlF == 1]  # unique within flank, kmer-sorted
    segF = fsg[rowsF]
    kmF = fkm[rowsF]
    if not len(rowsF):
        return segF, kmF, np.empty(0, np.int64), np.empty(0, bool)
    genF = genomic_kmers.get_abundances(kmF)
    g1 = genF == 1
    cs = np.cumsum(g1)
    seg_new = np.ones(len(segF), bool)
    seg_new[1:] = segF[1:] != segF[:-1]
    base = np.maximum.accumulate(np.where(seg_new, cs - g1, 0))
    r = cs - g1 - base  # rank among genome-unique, per flank
    chosen = g1 & (r < 12)
    return segF, kmF, genF, chosen


def select_kmers(
    variant,
    occurrences: Dict[int, List[int]],
    is_biallelic: bool,
    genomic_counter: KmerCounter,
) -> Dict[int, List[int]]:
    """Pick unique kmers per allele (see _select_kmers_with_counts)."""
    sorted_kmers = sorted(occurrences.keys())
    if sorted_kmers:
        genomic_counts = genomic_counter.get_abundances(
            np.array(sorted_kmers, dtype=np.uint64)
        )
    else:
        genomic_counts = np.empty(0, dtype=np.int64)
    return _select_kmers_with_counts(
        variant, occurrences, is_biallelic, sorted_kmers, genomic_counts
    )


def _select_kmers_with_counts(
    variant,
    occurrences: Dict[int, List[int]],
    is_biallelic: bool,
    sorted_kmers: List[int],
    genomic_counts: np.ndarray,
) -> Dict[int, List[int]]:
    """Pick unique kmers per allele with round-robin caps.

    A kmer survives iff: genome-wide count equals its local count
    (unique to this bubble), it lies on exactly one allele, and that
    allele is covered by >= 1 path. Then a round-robin over alleles (in
    allele-id order, kmers in lexicographic order) picks at most
    16 (biallelic) / 32 kmers per allele and at most
    max(nr_paths, 301) in total. (reference src/uniquekmercomputer.cpp:45-92)
    """
    allele_to_kmers: Dict[int, List[int]] = {}
    covered = set(variant.paths)  # alleles carried by >= 1 path
    # kmers iterate in packed-integer (== lexicographic) order, matching
    # the reference's ordered std::map<mer_dna, ...>
    for kmer, genomic_count in zip(sorted_kmers, genomic_counts):
        local_count = len(occurrences[kmer])
        if genomic_count - local_count != 0:
            continue
        if local_count > 1:
            continue
        allele = occurrences[kmer][0]
        if allele not in covered:
            continue
        allele_to_kmers.setdefault(allele, []).append(kmer)

    max_total = max(variant.nr_of_paths(), 301)
    max_kmers = 16 if is_biallelic else 32
    result: Dict[int, List[int]] = {}
    nr_selected = 0
    cursor = {a: 0 for a in allele_to_kmers}
    keep_adding = True
    while nr_selected < max_total and keep_adding:
        kmer_added = False
        for a in sorted(allele_to_kmers):
            queue = allele_to_kmers[a]
            picked = result.setdefault(a, [])
            if cursor[a] < len(queue) and len(picked) < max_kmers:
                picked.append(queue[cursor[a]])
                cursor[a] += 1
                kmer_added = True
                nr_selected += 1
            if nr_selected >= max_total:
                break
        keep_adding = kmer_added
    return {a: kmers for a, kmers in result.items() if kmers}


def _sort_within_groups(
    values: np.ndarray, groups: np.ndarray, n_groups: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Ascending sort of ``values`` within each run of equal ``groups``
    (groups non-decreasing). Equivalent to applying
    ``np.lexsort((values, groups))`` — but the group structure makes it
    thousands of tiny cache-local native sorts instead of one
    multi-million-element lexsort (the selection pipeline's wall)."""
    from . import native

    if len(values) == 0:
        return values, groups
    off = np.searchsorted(groups, np.arange(n_groups + 1))
    values = np.ascontiguousarray(values, dtype=np.uint64)
    if native.sort_segments(values, off):
        return values, groups
    order = np.lexsort((values, groups))
    return values[order], groups[order]


def _stable_kv_sort_within_groups(
    keys: np.ndarray, payload: np.ndarray, groups: np.ndarray,
    n_groups: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """STABLE per-group co-sort of (key, payload) by key — equivalent
    to applying ``np.lexsort((keys, groups))`` to both arrays (lexsort
    is stable, so equal keys keep their original payload order)."""
    from . import native

    if len(keys) == 0:
        return keys, payload
    off = np.searchsorted(groups, np.arange(n_groups + 1))
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    payload = np.ascontiguousarray(payload, dtype=np.uint64)
    if native.kv_sort_segments(keys, payload, off):
        return keys, payload
    order = np.lexsort((keys, groups))
    return keys[order], payload[order]


def _concat(parts: List[np.ndarray]) -> np.ndarray:
    if not parts:
        return np.empty(0, dtype=np.uint64)
    return np.concatenate(parts) if len(parts) > 1 else parts[0]


def _split_like(flat: np.ndarray, parts: List[np.ndarray]) -> List[np.ndarray]:
    """Split a batched-lookup result back into per-part arrays."""
    out = []
    pos = 0
    for p in parts:
        out.append(flat[pos : pos + len(p)])
        pos += len(p)
    return out


def _collect_allele_occurrences(
    variant, k: int, record: UniqueKmersRecord
) -> Dict[int, List[int]]:
    """Enumerate per-allele unique kmers across all defined alleles.

    occurrences[kmer] = list of alleles where the kmer is unique within
    the allele. Undefined alleles are flagged on the record and skipped.
    (reference src/uniquekmercomputer.cpp:125-134)
    """
    from .mer import unique_kmers_of_allele

    occurrences: Dict[int, List[int]] = {}
    for a in range(variant.nr_of_alleles()):
        if variant.is_undefined_allele(a):
            record.set_undefined_allele(a)
            continue
        allele_seq = variant.get_allele_sequence(a)
        for kmer in unique_kmers_of_allele(allele_seq, k):
            occurrences.setdefault(int(kmer), []).append(a)
    return occurrences


def _make_record(variant) -> Tuple[UniqueKmersRecord, bool]:
    path_to_alleles = [
        variant.get_allele_on_path(p) for p in range(variant.nr_of_paths())
    ]
    is_biallelic = all(a in (0, 1) for a in path_to_alleles)
    record = UniqueKmersRecord(variant.get_start_position(), path_to_alleles)
    return record, is_biallelic


class UniqueKmerComputer:
    """Genotype-time selection: kmers + read counts + local coverage.

    (reference src/uniquekmercomputer.cpp:34-253)
    """

    def __init__(
        self,
        genomic_kmers: KmerCounter,
        read_kmers: KmerCounter,
        graph: ChromosomeGraph,
        kmer_coverage: int,
    ):
        self.genomic_kmers = genomic_kmers
        self.read_kmers = read_kmers
        self.graph = graph
        self.kmer_coverage = kmer_coverage

    BLOCK = 2048  # variants per flat batch (bounds memory, amortizes
    #               numpy/native call overhead across bubbles)

    def compute_unique_kmers(
        self,
        probabilities: ProbabilityTable,
        delete_processed_variants: bool = False,
    ) -> List[UniqueKmersRecord]:
        """Flat-vectorized selection: one enumeration + three sorts per
        BLOCK of bubbles instead of a numpy pipeline per allele.

        Equivalent to :meth:`compute_unique_kmers_reference` (tested
        bubble-for-bubble); the per-bubble loops were the genome-scale
        wall. Key identity used: the reference keeps a kmer iff
        genomic_count == local_count and local_count == 1 and its
        allele is path-covered (src/uniquekmercomputer.cpp:45-92),
        which is exactly local_count == 1 AND genomic_count == 1 AND
        covered.
        """
        result: List[UniqueKmersRecord] = []
        k = self.graph.kmer_size
        nr_variants = self.graph.size()
        min_cov = self.kmer_coverage // 4
        max_cov = self.kmer_coverage * 4

        hdr = self.graph.selection_header()
        for block_start in range(0, nr_variants, self.BLOCK):
            block = range(
                block_start, min(block_start + self.BLOCK, nr_variants)
            )
            V = len(block)
            (records, seg_seqs, seg_var, seg_allele, flank_seqs,
             max_kmers, max_total, covered_keys) = _prepare_block(
                self.graph, hdr, block_start, V, stepwise=False
            )

            fv, fa, fk = _select_block_kmers(
                seg_seqs, seg_var, seg_allele, covered_keys, max_kmers,
                max_total, V, k, self.genomic_kmers,
            )

            # ---- local coverage from flanking kmers
            cov_sum = np.zeros(V, np.int64)
            cov_cnt = np.zeros(V, np.int64)
            segF, kmF, _genF, chosen = _unique_flank_kmers(
                flank_seqs, k, self.genomic_kmers
            )
            if len(kmF):
                readF = self.read_kmers.get_abundances(kmF)
                contrib = chosen & (readF >= min_cov) & (readF <= max_cov)
                varF = (segF // 2)[contrib]
                cov_sum = np.bincount(
                    varF, weights=readF[contrib].astype(np.float64),
                    minlength=V,
                ).astype(np.int64)
                cov_cnt = np.bincount(varF, minlength=V)

            # ---- read counts + probability filter, bulk over the block
            read_counts = self.read_kmers.get_abundances(fk)
            coverage_v = np.where(
                (cov_cnt > 0) & (cov_sum > 0),
                cov_sum // np.maximum(cov_cnt, 1),
                self.kmer_coverage,
            ).astype(np.int64)
            if len(fk):
                probs = probabilities.get_probabilities_rows(
                    coverage_v[fv], read_counts
                )
                keepk = (probs > 0).any(axis=1)
            else:
                keepk = np.zeros(0, bool)
            fv2 = fv[keepk]
            fa2 = fa[keepk].astype(np.int32)
            counts2 = read_counts[keepk].astype(np.int32)
            row_off = np.searchsorted(fv2, np.arange(V + 1)).tolist()
            coverage_l = coverage_v.tolist()
            fa2_list = fa2.tolist()
            for j in range(V):
                record = records[j]
                record.coverage = coverage_l[j]
                lo, hi = row_off[j], row_off[j + 1]
                if hi > lo:
                    # bulk equivalent of insert_kmers_single: per-record
                    # views of the block arrays (single-allele kmers)
                    record._kmer_counts = counts2[lo:hi]
                    record.allele_data = fa2[lo:hi]
                    record.allele_indptr = np.arange(
                        hi - lo + 1, dtype=np.int32
                    )
                    # alleles are sorted within the record slice: skip
                    # duplicate runs so setdefault runs per distinct
                    # allele (~2 per record) instead of per kmer (~40)
                    alleles = record.alleles
                    prev = None
                    for a in fa2_list[lo:hi]:
                        if a != prev:
                            alleles.setdefault(a, False)
                            prev = a
                result.append(record)

            if delete_processed_variants:
                first = block[0]
                if first > 0:
                    self.graph.delete_variant(first - 1)
                for v in block[:-1]:
                    self.graph.delete_variant(v)
                if block[-1] == nr_variants - 1:
                    self.graph.delete_variant(block[-1])
        return result

    def compute_unique_kmers_reference(
        self,
        probabilities: ProbabilityTable,
        delete_processed_variants: bool = False,
    ) -> List[UniqueKmersRecord]:
        from .mer import unique_kmers_of_allele

        result: List[UniqueKmersRecord] = []
        k = self.graph.kmer_size
        length = 2 * k
        nr_variants = self.graph.size()
        min_cov = self.kmer_coverage // 4
        max_cov = self.kmer_coverage * 4

        for block_start in range(0, nr_variants, self.BLOCK):
            block = range(
                block_start, min(block_start + self.BLOCK, nr_variants)
            )
            # pass 1: enumerate allele + flanking kmers, gather queries
            prep = []
            gen_parts: List[np.ndarray] = []
            flank_parts: List[np.ndarray] = []
            for v in block:
                variant = self.graph.get_variant(v)
                record, is_biallelic = _make_record(variant)
                occurrences = _collect_allele_occurrences(variant, k, record)
                sorted_kmers = np.fromiter(
                    sorted(occurrences), dtype=np.uint64, count=len(occurrences)
                )
                flanks = [
                    np.sort(
                        unique_kmers_of_allele(
                            self.graph.get_left_overhang(v, length), k
                        )
                    ),
                    np.sort(
                        unique_kmers_of_allele(
                            self.graph.get_right_overhang(v, length), k
                        )
                    ),
                ]
                prep.append((variant, record, is_biallelic, occurrences,
                             sorted_kmers, flanks))
                gen_parts.append(sorted_kmers)
                flank_parts.extend(flanks)

            # pass 2: three batched abundance lookups for the block
            gen_counts = _split_like(
                self.genomic_kmers.get_abundances(_concat(gen_parts)),
                gen_parts,
            )
            flank_gen = _split_like(
                self.genomic_kmers.get_abundances(_concat(flank_parts)),
                flank_parts,
            )
            flank_read = _split_like(
                self.read_kmers.get_abundances(_concat(flank_parts)),
                flank_parts,
            )

            # pass 3: per-bubble selection + local coverage
            sel_parts: List[np.ndarray] = []
            selections = []
            for i, (variant, record, is_biallelic, occurrences,
                    sorted_kmers, flanks) in enumerate(prep):
                allele_to_kmers = _select_kmers_with_counts(
                    variant, occurrences, is_biallelic,
                    sorted_kmers.tolist(), gen_counts[i],
                )
                # local coverage: mean read count of <=12 genome-unique
                # flanking kmers per side, counts outside
                # [peak/4, 4*peak] skipped AFTER the <=12 cap counter
                # (reference src/uniquekmercomputer.cpp:195-253)
                total_coverage = 0
                total_kmers = 0
                for side in range(2):
                    g = flank_gen[2 * i + side]
                    r = flank_read[2 * i + side]
                    selected = 0
                    for gi, ri in zip(g, r):
                        if selected >= 12:
                            break
                        if gi == 1:
                            selected += 1
                            if ri < min_cov or ri > max_cov:
                                continue
                            total_coverage += int(ri)
                            total_kmers += 1
                if total_kmers > 0 and total_coverage > 0:
                    record.set_coverage(total_coverage // total_kmers)
                else:
                    record.set_coverage(self.kmer_coverage)

                ordered = [
                    (a, kmer)
                    for a in sorted(allele_to_kmers)
                    for kmer in allele_to_kmers[a]
                ]
                selections.append((record, ordered))
                sel_parts.append(
                    np.fromiter(
                        (kmer for _, kmer in ordered), dtype=np.uint64,
                        count=len(ordered),
                    )
                )

            sel_counts = _split_like(
                self.read_kmers.get_abundances(_concat(sel_parts)), sel_parts
            )

            for i, (record, ordered) in enumerate(selections):
                counts = sel_counts[i]
                coverage = record.get_coverage()
                if len(ordered):
                    probs = probabilities.get_probabilities(coverage, counts)
                    # skip kmers with all-zero probabilities
                    keep = (probs > 0).any(axis=1)
                    alleles_arr = np.fromiter(
                        (a for a, _kmer in ordered), dtype=np.int32,
                        count=len(ordered),
                    )
                    record.insert_kmers_single(counts[keep], alleles_arr[keep])
                result.append(record)

            if delete_processed_variants:
                # keep the block's last variant: the next block's first
                # left overhang needs its end position
                first = block[0]
                if first > 0:
                    self.graph.delete_variant(first - 1)
                for v in block[:-1]:
                    self.graph.delete_variant(v)
                if block[-1] == nr_variants - 1:
                    self.graph.delete_variant(block[-1])
        return result

    def compute_local_coverage(self, var_index: int, length: int) -> int:
        """Mean read count of <=12 genome-unique flanking kmers per side,
        clamped to [peak/4, 4*peak]; fallback = global peak.

        (reference src/uniquekmercomputer.cpp:195-253)
        """
        from .mer import unique_kmers_of_allele

        k = self.graph.kmer_size
        min_cov = self.kmer_coverage // 4
        max_cov = self.kmer_coverage * 4
        total_coverage = 0
        total_kmers = 0
        max_number = 12

        for overhang in (
            self.graph.get_left_overhang(var_index, length),
            self.graph.get_right_overhang(var_index, length),
        ):
            selected = 0
            kmers = sorted(int(x) for x in unique_kmers_of_allele(overhang, k))
            if kmers:
                genomic = self.genomic_kmers.get_abundances(
                    np.array(kmers, dtype=np.uint64)
                )
                reads = self.read_kmers.get_abundances(
                    np.array(kmers, dtype=np.uint64)
                )
                for g, r in zip(genomic, reads):
                    if selected >= max_number:
                        break
                    if g == 1:
                        # counter incremented before the range check, for
                        # consistency with the stepwise computer
                        selected += 1
                        if r < min_cov or r > max_cov:
                            continue
                        total_coverage += int(r)
                        total_kmers += 1
        if total_kmers > 0 and total_coverage > 0:
            return total_coverage // total_kmers
        return self.kmer_coverage


class StepwiseUniqueKmerComputer:
    """Index-time selection: no read counts yet; writes the kmer TSV.

    (reference src/stepwiseuniquekmercomputer.cpp:96-265)
    """

    def __init__(self, genomic_kmers: KmerCounter, graph: ChromosomeGraph):
        self.genomic_kmers = genomic_kmers
        self.graph = graph

    BLOCK = 512

    def compute_unique_kmers(
        self, tsv_filename: str, delete_processed_variants: bool = False
    ) -> List[UniqueKmersRecord]:
        """Flat-vectorized index-time selection (same machinery as
        UniqueKmerComputer.compute_unique_kmers, without read counts)
        + bulk TSV emission. Byte-identical TSVs and records to
        :meth:`compute_unique_kmers_reference` (tested)."""
        import gzip

        from .mer import decode_kmers_bulk

        result: List[UniqueKmersRecord] = []
        k = self.graph.kmer_size
        nr_variants = self.graph.size()
        with gzip.open(tsv_filename, "wt", compresslevel=1) as out:
            out.write(
                "#chromosome\tstart\tend\tunique_kmers\tunique_kmers_overhang\n"
            )
            hdr = self.graph.selection_header()
            chrom_name = self.graph.chromosome
            for block_start in range(0, nr_variants, self.BLOCK):
                block = range(
                    block_start, min(block_start + self.BLOCK, nr_variants)
                )
                V = len(block)
                block_end = block_start + V
                (records, seg_seqs, seg_var, seg_allele, flank_seqs,
                 max_kmers, max_total, covered_keys) = _prepare_block(
                    self.graph, hdr, block_start, V, stepwise=True
                )
                starts_l = hdr.starts[block_start:block_end].tolist()
                ends_l = hdr.ends[block_start:block_end].tolist()

                fv, fa, fk = _select_block_kmers(
                    seg_seqs, seg_var, seg_allele, covered_keys,
                    max_kmers, max_total, V, k, self.genomic_kmers,
                )

                # flanks: <=12 genome-unique kmers per side
                segF, kmF, _genF, chosen = _unique_flank_kmers(
                    flank_seqs, k, self.genomic_kmers
                )
                segF, kmF = segF[chosen], kmF[chosen]

                # per-record insert + bulk TSV
                sel_off = np.searchsorted(fv, np.arange(V + 1)).tolist()
                fa_list = fa.tolist()
                for j in range(V):
                    lo, hi = sel_off[j], sel_off[j + 1]
                    record = records[j]
                    if hi > lo:
                        record._kmer_counts = np.zeros(hi - lo, np.int32)
                        record.allele_data = fa[lo:hi].astype(np.int32)
                        record.allele_indptr = np.arange(
                            hi - lo + 1, dtype=np.int32
                        )
                        alleles = record.alleles
                        for a in fa_list[lo:hi]:
                            alleles.setdefault(a, False)
                    result.append(record)
                kmer_strs_all = decode_kmers_bulk(fk, k)
                flank_strs_all = decode_kmers_bulk(kmF, k)
                row_off = np.searchsorted(fv, np.arange(V + 1))
                flank_var = segF // 2
                frow_off = np.searchsorted(flank_var, np.arange(V + 1))
                lines: List[str] = []
                for j in range(V):
                    ks = kmer_strs_all[row_off[j]:row_off[j + 1]]
                    fs = flank_strs_all[frow_off[j]:frow_off[j + 1]]
                    lines.append(
                        f"{chrom_name}\t"
                        f"{starts_l[j]}\t"
                        f"{ends_l[j]}\t"
                        f"{b','.join(ks).decode() if len(ks) else 'nan'}\t"
                        f"{b','.join(fs).decode() if len(fs) else 'nan'}\n"
                    )
                out.write("".join(lines))

                if delete_processed_variants:
                    first = block[0]
                    if first > 0:
                        self.graph.delete_variant(first - 1)
                    for v in block[:-1]:
                        self.graph.delete_variant(v)
                    if block[-1] == nr_variants - 1:
                        self.graph.delete_variant(block[-1])
        return result

    def compute_unique_kmers_reference(
        self, tsv_filename: str, delete_processed_variants: bool = False
    ) -> List[UniqueKmersRecord]:
        import gzip

        from .mer import unique_kmers_of_allele

        result: List[UniqueKmersRecord] = []
        k = self.graph.kmer_size
        overhang_size = 2 * k
        nr_variants = self.graph.size()
        with gzip.open(tsv_filename, "wt", compresslevel=1) as out:
            out.write("#chromosome\tstart\tend\tunique_kmers\tunique_kmers_overhang\n")
            for block_start in range(0, nr_variants, self.BLOCK):
                block = range(
                    block_start, min(block_start + self.BLOCK, nr_variants)
                )
                prep = []
                gen_parts: List[np.ndarray] = []
                flank_parts: List[np.ndarray] = []
                for v in block:
                    variant = self.graph.get_variant(v)
                    record, is_biallelic = _make_record(variant)
                    record.set_coverage(0)
                    occurrences = _collect_allele_occurrences(
                        variant, k, record
                    )
                    sorted_kmers = np.fromiter(
                        sorted(occurrences), dtype=np.uint64,
                        count=len(occurrences),
                    )
                    flanks = [
                        np.sort(
                            unique_kmers_of_allele(
                                self.graph.get_left_overhang(v, overhang_size), k
                            )
                        ),
                        np.sort(
                            unique_kmers_of_allele(
                                self.graph.get_right_overhang(v, overhang_size), k
                            )
                        ),
                    ]
                    prep.append((variant, record, is_biallelic, occurrences,
                                 sorted_kmers, flanks))
                    gen_parts.append(sorted_kmers)
                    flank_parts.extend(flanks)

                gen_counts = _split_like(
                    self.genomic_kmers.get_abundances(_concat(gen_parts)),
                    gen_parts,
                )
                flank_gen = _split_like(
                    self.genomic_kmers.get_abundances(_concat(flank_parts)),
                    flank_parts,
                )

                for i, (variant, record, is_biallelic, occurrences,
                        sorted_kmers, flanks) in enumerate(prep):
                    allele_to_kmers = _select_kmers_with_counts(
                        variant, occurrences, is_biallelic,
                        sorted_kmers.tolist(), gen_counts[i],
                    )
                    kmer_strs: List[str] = []
                    sel_alleles: List[int] = []
                    for a in sorted(allele_to_kmers):
                        for kmer in allele_to_kmers[a]:
                            sel_alleles.append(a)
                            kmer_strs.append(decode_kmer(kmer, k))
                    record.insert_kmers_single(
                        np.zeros(len(sel_alleles), dtype=np.int32),
                        np.asarray(sel_alleles, dtype=np.int32),
                    )
                    # <=12 genome-unique kmers per flank
                    # (reference src/stepwiseuniquekmercomputer.cpp:227-265)
                    flanking: List[str] = []
                    for side in range(2):
                        g = flank_gen[2 * i + side]
                        selected = 0
                        for kmer, gi in zip(flanks[side], g):
                            if selected >= 12:
                                break
                            if gi == 1:
                                flanking.append(decode_kmer(int(kmer), k))
                                selected += 1
                    out.write(
                        f"{variant.chromosome}\t{variant.get_start_position()}\t"
                        f"{variant.get_end_position()}\t"
                        f"{','.join(kmer_strs) if kmer_strs else 'nan'}\t"
                        f"{','.join(flanking) if flanking else 'nan'}\n"
                    )
                    result.append(record)

                if delete_processed_variants:
                    first = block[0]
                    if first > 0:
                        self.graph.delete_variant(first - 1)
                    for v in block[:-1]:
                        self.graph.delete_variant(v)
                    if block[-1] == nr_variants - 1:
                        self.graph.delete_variant(block[-1])
        return result

    def determine_unique_flanking_kmers(
        self, var_index: int, length: int
    ) -> List[str]:
        """<=12 genome-unique kmers per flank, as strings.

        (reference src/stepwiseuniquekmercomputer.cpp:227-265)
        """
        from .mer import unique_kmers_of_allele

        k = self.graph.kmer_size
        max_number = 12
        result: List[str] = []
        for overhang in (
            self.graph.get_left_overhang(var_index, length),
            self.graph.get_right_overhang(var_index, length),
        ):
            selected = 0
            kmers = sorted(int(x) for x in unique_kmers_of_allele(overhang, k))
            if kmers:
                genomic = self.genomic_kmers.get_abundances(
                    np.array(kmers, dtype=np.uint64)
                )
                for kmer, g in zip(kmers, genomic):
                    if selected >= max_number:
                        break
                    if g == 1:
                        result.append(decode_kmer(kmer, k))
                        selected += 1
        return result
