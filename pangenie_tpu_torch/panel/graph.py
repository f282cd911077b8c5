"""Per-chromosome pangenome graph + VCF output writers.

Replaces the reference ``Graph`` class (src/graph.cpp:46-609): owns the
chromosome's merged variant bubbles, its reference sequence, and the
variant-ID bookkeeping, and renders the genotyping / phasing /
sampled-panel VCFs (including separation of merged bubbles back into
individual VCF records and re-projection of likelihoods onto defined
alleles).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from ..io.fasta import FastaReader
from .variant import GenotypeLikelihoods, SampledPanel, VariantBubble


def _current_date() -> str:
    t = time.localtime()
    return f"{t.tm_year}{t.tm_mon:02d}{t.tm_mday:02d}"


def _format_float(value: float, precision: int = 6) -> str:
    """C++ ostream << setprecision(p) formatting (%.{p}g)."""
    return f"{value:.{precision}g}"


def _materialize_bulk_rows(genotyping_result, bulk, fast_ok) -> None:
    """Turn array-resident biallelic likelihoods back into per-variant
    dicts for rows that take a dict-reading (slow) path. When
    ``fast_ok`` is given, rows already rendered from the array are
    skipped; zero keys are kept, matching the scatter's dict shape."""
    bmask, bvals = bulk
    rows = bmask if fast_ok is None else (bmask & ~fast_ok)
    idx = np.nonzero(rows)[0]
    for i in idx.tolist():
        v = bvals[i]
        genotyping_result[i].likelihoods = {
            (0, 0): v[0], (0, 1): v[1], (1, 1): v[2]
        }


def construct_index(alleles: Sequence, reference_added: bool) -> List[int]:
    """Stable argsort of alleles (optionally skipping a leading REF).

    (reference src/graph.hpp:25-38). std::sort is not stable, but allele
    sequences within a record are unique, so sorted() is equivalent.
    """
    offset = 1 if reference_added else 0
    length = len(alleles) - offset
    index = list(range(length))
    index.sort(key=lambda a: alleles[a + offset])
    return index


@dataclass
class SelectionHeader:
    """Bulk per-chromosome header arrays for unique-kmer selection."""

    chrom_seq: bytes           # the chromosome's reference sequence
    starts: np.ndarray         # [N] bubble start positions
    ends: np.ndarray           # [N] bubble end positions
    paths: np.ndarray          # [N, P] path -> merged allele id
    is_biallelic: np.ndarray   # [N] all path alleles in {0, 1}
    covered_data: np.ndarray   # CSR values: sorted unique covered alleles
    covered_indptr: np.ndarray  # [N+1]
    left_lo: np.ndarray        # [N] left overhang start (clipped)
    right_hi: np.ndarray       # [N] right overhang end (clipped)


class ChromosomeGraph:
    """Container of merged variant bubbles for one chromosome."""

    def __init__(
        self,
        fasta_reader: FastaReader,
        chromosome: str,
        kmer_size: int,
        add_reference: bool,
    ):
        self.fasta_reader = fasta_reader
        self.chromosome = chromosome
        self.kmer_size = kmer_size
        self.add_reference = add_reference
        self.variants: List[Optional[VariantBubble]] = []
        self.variant_ids: List[List[str]] = []
        self.variants_deleted = False
        self._header_cache = None

    # -- construction ----------------------------------------------------

    def size(self) -> int:
        return len(self.variants)

    def get_variant(self, index: int) -> VariantBubble:
        v = self.variants[index]
        if v is None:
            raise RuntimeError(
                "ChromosomeGraph.get_variant: variant was deleted; re-build object."
            )
        return v

    def add_variant_cluster(
        self,
        cluster: List[VariantBubble],
        cluster_ids: List[List[str]],
        only_defined_ids: bool = False,
    ) -> None:
        """Fold a cluster of nearby variants into one merged bubble.

        (reference src/graph.cpp:66-100)
        """
        if not cluster:
            return
        assert len(cluster) == len(cluster_ids)
        for variant, ids in zip(cluster, cluster_ids):
            if ids:
                assert len(variant.allele_sequences) == 1
                alleles = variant.allele_sequences[0]
                if only_defined_ids:
                    from ..io.sequence import contains_undefined

                    defined = [a for a in alleles if not contains_undefined(a)]
                    assert len(defined) == len(ids) + 1
                    self._insert_ids(defined, ids, True)
                else:
                    self._insert_ids(alleles, ids, True)
            else:
                self.variant_ids.append([])

        combined = cluster[0]
        for v in cluster[1:]:
            combined.combine_variants(v)
        combined.add_flanking_sequence()
        self.variants.append(combined)
        self._header_cache = None

    def __getstate__(self):
        # the selection header duplicates the chromosome sequence; keep
        # it out of Graph pickles and rebuild on demand after load
        state = self.__dict__.copy()
        state["_header_cache"] = None
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self.__dict__.setdefault("_header_cache", None)

    def _insert_ids(
        self, alleles: Sequence[bytes], ids: List[str], reference_added: bool
    ) -> None:
        """Store IDs in lexicographic order of their ALT alleles.

        (reference src/graph.cpp:20-29)
        """
        index = construct_index(alleles, reference_added)
        self.variant_ids.append([ids[i] for i in index])

    def _get_ids(
        self, alt_alleles: Sequence[str], variant_index: int, reference_added: bool
    ) -> str:
        """Recover IDs in output ALT order. (reference src/graph.cpp:31-44)"""
        index = construct_index(alt_alleles, reference_added)
        sorted_ids = [""] * len(index)
        for i, idx in enumerate(index):
            sorted_ids[idx] = self.variant_ids[variant_index][i]
        return ",".join(sorted_ids)

    def delete_variant(self, index: int) -> None:
        if index >= self.size():
            raise RuntimeError("ChromosomeGraph.delete_variant: index out of bounds.")
        if self.variants[index] is not None:
            self.variants[index] = None
            self.variants_deleted = True

    def variants_were_deleted(self) -> bool:
        return self.variants_deleted

    # -- bulk selection header -------------------------------------------

    def selection_header(self) -> "SelectionHeader":
        """Flat per-chromosome arrays consumed by the unique-kmer
        selection drivers (kmers/unique.py).

        The reference does the equivalent header work — path lookups,
        covered-allele sets, overhang coordinates — per bubble inside
        C++ threads (src/uniquekmercomputer.cpp:95-134, :195-253); a
        per-variant Python/numpy loop over millions of bubbles was the
        genome-scale selection wall, so it is computed ONCE here as bulk
        array ops and cached.
        """
        if self._header_cache is not None:
            return self._header_cache
        if self.variants_deleted:
            raise RuntimeError(
                "ChromosomeGraph.selection_header: variants were deleted."
            )
        N = self.size()
        length = 2 * self.kmer_size
        chrom_seq = self.fasta_reader.get_sequence(self.chromosome)
        starts = np.empty(N, dtype=np.int64)
        ends = np.empty(N, dtype=np.int64)
        P = self.variants[0].nr_of_paths() if N else 0
        paths = np.empty((N, P), dtype=np.int32)
        for i, v in enumerate(self.variants):
            starts[i] = v.start_position
            seqs = v.allele_sequences
            # uncombined bubbles (the overwhelming majority): end is
            # start + ref length — skip the get_end_position call
            ends[i] = (
                v.start_position + len(seqs[0][0])
                if len(seqs) == 1 else v.get_end_position()
            )
            paths[i] = v.paths
        # covered (path-carried) alleles per variant, sorted unique, CSR
        if N and P:
            srt = np.sort(paths, axis=1)
            first = np.ones((N, P), dtype=bool)
            first[:, 1:] = srt[:, 1:] != srt[:, :-1]
            covered_data = srt[first].astype(np.int64)
            counts = first.sum(axis=1)
        else:
            covered_data = np.empty(0, dtype=np.int64)
            counts = np.zeros(N, dtype=np.int64)
        covered_indptr = np.zeros(N + 1, dtype=np.int64)
        np.cumsum(counts, out=covered_indptr[1:])
        # overhang windows, clipped at neighbouring bubbles
        # (reference src/graph.cpp:554-592)
        prev_end = np.concatenate([[0], ends[:-1]])
        next_start = np.concatenate([starts[1:], [len(chrom_seq)]])
        left_lo = np.maximum(starts - length, prev_end)
        right_hi = np.minimum(ends + length, next_start)
        self._header_cache = SelectionHeader(
            chrom_seq=chrom_seq,
            starts=starts,
            ends=ends,
            paths=paths,
            is_biallelic=(paths <= 1).all(axis=1) if N else np.zeros(0, bool),
            covered_data=covered_data,
            covered_indptr=covered_indptr,
            left_lo=left_lo,
            right_hi=right_hi,
        )
        return self._header_cache

    # -- overhangs for local-coverage kmers ------------------------------

    def get_left_overhang(self, index: int, length: int) -> bytes:
        """Reference sequence left of bubble `index`, clipped at the
        previous bubble. (reference src/graph.cpp:554-572)
        """
        cur_start = self.get_variant(index).get_start_position()
        prev_end = 0
        if index > 0:
            prev_end = self.get_variant(index - 1).get_end_position()
        overhang_start = max(cur_start - length, prev_end)
        return self.fasta_reader.get_subsequence(
            self.chromosome, overhang_start, cur_start
        )

    def get_right_overhang(self, index: int, length: int) -> bytes:
        cur_end = self.get_variant(index).get_end_position()
        next_start = self.fasta_reader.get_size_of(self.chromosome)
        if index < self.size() - 1:
            next_start = self.get_variant(index + 1).get_start_position()
        overhang_end = min(cur_end + length, next_start)
        return self.fasta_reader.get_subsequence(self.chromosome, cur_end, overhang_end)

    # -- VCF writers -----------------------------------------------------

    _GT_HEADER = (
        "##fileformat=VCFv4.2\n"
        "##fileDate={date}\n"
        '##INFO=<ID=AF,Number=A,Type=Float,Description="Allele Frequency">\n'
        '##INFO=<ID=UK,Number=1,Type=Integer,Description="Total number of unique kmers.">\n'
        '##INFO=<ID=AK,Number=R,Type=Integer,Description="Number of unique kmers per allele. '
        'Will be -1 for alleles not covered by any input haplotype path">\n'
        '##INFO=<ID=MA,Number=1,Type=Integer,Description="Number of alleles missing in panel haplotypes.">\n'
        '##INFO=<ID=ID,Number=A,Type=String,Description="Variant IDs.">\n'
        '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">\n'
        '##FORMAT=<ID=GQ,Number=1,Type=Integer,Description="Genotype quality: phred scaled probability '
        'that the genotype is wrong.">\n'
        '##FORMAT=<ID=GL,Number=G,Type=Float,Description="Comma-separated log10-scaled genotype '
        'likelihoods for absent, heterozygous, homozygous.">\n'
        '##FORMAT=<ID=KC,Number=1,Type=Float,Description="Local kmer coverage.">\n'
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t{sample}\n"
    )

    def _separated_records(self, variant: VariantBubble, result):
        """Split a merged bubble into per-sub-variant (variant, result)."""
        if variant.is_combined():
            if isinstance(result, SampledPanel):
                return variant.separate_variants_panel(result, skip_flanks=True)
            return variant.separate_variants(result, skip_flanks=True)
        return [variant], [result]

    _KEYS3 = frozenset(((0, 0), (0, 1), (1, 1)))

    def materialize_bulk(self, genotyping_result, bulk) -> None:
        """Populate every bulk-masked row's likelihood dict from the
        array channel (for consumers that need the dict form)."""
        if bulk is not None:
            _materialize_bulk_rows(genotyping_result, bulk, None)

    def _bulk_genotype_lines(
        self,
        genotyping_result: List[GenotypeLikelihoods],
        ignore_imputed: bool,
        bulk=None,
    ):
        """Vectorized GT:GQ:GL rendering for plain biallelic records.

        Covers the overwhelmingly common case — uncombined bubble, two
        defined alleles, likelihoods over {(0,0),(0,1),(1,1)} (or
        empty, which the reference calls 0/0 with probability 1,
        src/graph.cpp:118-278). Returns (ok_mask, lines) where lines[i]
        is the full VCF line for fast rows; anything else (merged
        bubbles, undefined alleles, multiallelics, unnormalized
        likelihoods) keeps the exact per-record path.
        """
        N = self.size()
        ok = np.zeros(N, dtype=bool)
        lines: List[Optional[str]] = [None] * N
        if N == 0:
            return ok, lines
        hdr = self.selection_header()
        P = hdr.paths.shape[1]
        size_for_af = P - 1 if self.add_reference else P
        if size_for_af <= 0:
            return ok, lines
        af1 = (hdr.paths == 1).sum(axis=1) / float(size_for_af)
        starts1 = hdr.starts + 1

        vals = np.zeros((N, 3), dtype=np.longdouble)
        uk = np.zeros(N, dtype=np.int64)
        kc = np.zeros(N, dtype=np.int64)
        refs: List[Optional[bytes]] = [None] * N
        alts: List[Optional[bytes]] = [None] * N
        keys3 = self._KEYS3
        from ..io.sequence import contains_undefined

        # array-resident channel: masked rows read their normalized
        # {(0,0),(0,1),(1,1)} values straight from the [M, 3] array
        if bulk is not None:
            bmask, bvals = bulk
            np.copyto(vals, bvals, where=bmask[:, None])
            bmask_l = bmask.tolist()
        else:
            bmask_l = None

        for i, variant in enumerate(self.variants):
            if len(variant.allele_sequences) != 1:
                continue  # merged bubble: slow path
            seqs0 = variant.allele_sequences[0]
            if len(variant.allele_combinations) != 2:
                continue
            if contains_undefined(seqs0[0]) or contains_undefined(seqs0[1]):
                continue
            gl = genotyping_result[i]
            if bmask_l is not None and bmask_l[i]:
                pass  # vals row already copied from the bulk array
            else:
                lh = gl.likelihoods
                if lh:
                    if len(lh) > 3 or not keys3.issuperset(lh):
                        continue
                    vals[i, 0] = lh.get((0, 0), 0.0)
                    vals[i, 1] = lh.get((0, 1), 0.0)
                    vals[i, 2] = lh.get((1, 1), 0.0)
                else:
                    vals[i, 0] = 1.0  # only-reference column: 0/0, P=1
            uk[i] = gl.nr_unique_kmers
            kc[i] = gl.coverage
            refs[i] = seqs0[0]
            alts[i] = seqs0[1]
            ok[i] = True

        if not ok.any():
            return ok, lines

        total = vals.sum(axis=1)
        # rows whose likelihoods are not normalized would raise in
        # get_genotype_quality — keep them on the per-record path so
        # the identical error surfaces
        ok &= ~(ok & (np.abs(total - 1.0) > 1e-10) & (vals.max(axis=1) > 0))
        vmax = vals.max(axis=1)
        # likeliest genotype: LAST maximal pair in sorted order, must be
        # a unique max within 1e-10 (src/genotypingresult.cpp:149-180)
        best_idx = 2 - np.argmax(vals[:, ::-1] == vmax[:, None], axis=1)
        close_n = (np.abs(vals - vmax[:, None]) < 1e-10).sum(axis=1)
        valid_gt = (vmax > 0) & (close_n == 1)
        if ignore_imputed:
            valid_gt &= uk != 0
        pbest = vals[np.arange(N), best_idx]
        prob_wrong = np.longdouble(1.0) - pbest
        with np.errstate(divide="ignore", invalid="ignore"):
            gq = (-10.0 * np.log10(prob_wrong)).astype(np.int64)
        gq = np.where(prob_wrong > 0, gq, 10000)
        with np.errstate(divide="ignore"):
            logs = np.where(vals > 0, np.log10(vals), -np.inf)

        gt_strs = ("0/0", "0/1", "1/1")
        chrom = self.chromosome
        variant_ids = self.variant_ids
        # counter (index into variant_ids) advances by the number of
        # separated sub-records per bubble
        sep_counts = np.fromiter(
            (len(v.allele_sequences) for v in self.variants),
            dtype=np.int64, count=N,
        )
        counters = np.concatenate([[0], np.cumsum(sep_counts[:-1])])
        af_l = af1.tolist()
        uk_l = uk.tolist()
        kc_l = kc.tolist()
        gq_l = gq.tolist()
        best_l = best_idx.tolist()
        valid_l = valid_gt.tolist()
        pos_l = starts1.tolist()
        counters_l = counters.tolist()
        for i in np.nonzero(ok)[0].tolist():
            ids = variant_ids[counters_l[i]]
            info = f"AF={af_l[i]:.6g};UK={uk_l[i]};MA=0"
            if ids:
                info += ";ID=" + ",".join(ids)
            if valid_l[i]:
                b = best_l[i]
                gt_field = f"{gt_strs[b]}:{gq_l[i]}:"
            else:
                gt_field = ".:.:"
            # format the LONGDOUBLE scalars, exactly as the per-record
            # path does (a float64 round-trip could flip the 4th digit)
            lrow = logs[i]
            lines[i] = (
                f"{chrom}\t{pos_l[i]}\t.\t"
                f"{refs[i].decode('ascii')}\t{alts[i].decode('ascii')}\t.\tPASS\t"
                f"{info}\tGT:GQ:GL:KC\t{gt_field}"
                f"{lrow[0]:.4g},{lrow[1]:.4g},{lrow[2]:.4g}:{kc_l[i]}\n"
            )
        return ok, lines

    def write_genotypes(
        self,
        filename: str,
        genotyping_result: List[GenotypeLikelihoods],
        write_header: bool,
        sample: str,
        ignore_imputed: bool = False,
        bulk=None,
    ) -> None:
        """Emit the GT:GQ:GL:KC genotyping VCF.

        (reference src/graph.cpp:118-278)
        """
        if self.variants_deleted:
            raise RuntimeError(
                "ChromosomeGraph.write_genotypes: variants were deleted; re-build object."
            )
        if len(genotyping_result) != self.size():
            raise RuntimeError(
                "ChromosomeGraph.write_genotypes: number of variants and genotypes differ."
            )
        fast_ok, fast_lines = self._bulk_genotype_lines(
            genotyping_result, ignore_imputed, bulk
        )
        if bulk is not None:
            _materialize_bulk_rows(genotyping_result, bulk, fast_ok)
        mode = "w" if write_header else "a"
        with open(filename, mode) as out:
            if write_header:
                out.write(self._GT_HEADER.format(date=_current_date(), sample=sample))
            counter = 0
            for i in range(self.size()):
                if fast_ok[i]:
                    out.write(fast_lines[i])
                    counter += 1
                    continue
                variant = self.get_variant(i)
                coverage = genotyping_result[i].coverage
                nr_unique_kmers = genotyping_result[i].nr_unique_kmers
                singles, single_likelihoods = self._separated_records(
                    variant, genotyping_result[i]
                )
                for v, likelihoods in zip(singles, single_likelihoods):
                    v.remove_flanking_sequence()
                    nr_alleles = v.nr_of_alleles()
                    if nr_alleles < 2:
                        raise RuntimeError(
                            "ChromosomeGraph.write_genotypes: <2 alleles at position "
                            f"{v.get_start_position()}"
                        )
                    alt_alleles = []
                    defined_alleles = [0]
                    for a in range(1, nr_alleles):
                        if not v.is_undefined_allele(a):
                            alt_alleles.append(v.get_allele_string(a))
                            defined_alleles.append(a)
                    allele_freqs = v.all_allele_frequencies(self.add_reference)
                    af = ",".join(
                        _format_float(allele_freqs[a]) for a in defined_alleles[1:]
                    )

                    nr_missing = nr_alleles - len(defined_alleles)
                    gl = likelihoods
                    if gl.contains_no_likelihoods():
                        # only-reference-covered column: call 0/0 with prob 1
                        gl = GenotypeLikelihoods(
                            likelihoods={(0, 0): 1.0},
                            coverage=gl.coverage,
                            nr_unique_kmers=gl.nr_unique_kmers,
                        )
                    if nr_missing > 0:
                        gl = gl.get_specific_likelihoods(defined_alleles)
                    nr_out_alleles = len(defined_alleles)

                    info = f"AF={af};UK={nr_unique_kmers};MA={nr_missing}"
                    if self.variant_ids[counter]:
                        info += ";ID=" + self._get_ids(alt_alleles, counter, False)

                    genotype = gl.get_likeliest_genotype()
                    if ignore_imputed and nr_unique_kmers == 0:
                        genotype = (-1, -1)
                    if genotype != (-1, -1):
                        gt_field = (
                            f"{genotype[0]}/{genotype[1]}:"
                            f"{gl.get_genotype_quality(genotype[0], genotype[1])}:"
                        )
                    else:
                        gt_field = ".:.:"

                    all_likelihoods = gl.get_all_likelihoods(nr_out_alleles)
                    if len(all_likelihoods) < 3:
                        raise RuntimeError(
                            "ChromosomeGraph.write_genotypes: too few likelihoods at "
                            f"position {v.get_start_position()}"
                        )
                    gl_strs = []
                    for value in all_likelihoods:
                        # np.log10 keeps long-double precision: GL of a
                        # near-certain genotype is ~ -4e-19, not -0
                        lv = np.log10(value) if value > 0 else float("-inf")
                        gl_strs.append(_format_float(lv, 4))
                    out.write(
                        f"{v.chromosome}\t{v.get_start_position() + 1}\t.\t"
                        f"{v.get_allele_string(0)}\t{','.join(alt_alleles)}\t.\tPASS\t"
                        f"{info}\tGT:GQ:GL:KC\t{gt_field}{','.join(gl_strs)}:{coverage}\n"
                    )
                    counter += 1

    _PH_HEADER = (
        "##fileformat=VCFv4.2\n"
        "##fileDate={date}\n"
        '##INFO=<ID=AF,Number=A,Type=Float,Description="Allele Frequency">\n'
        '##INFO=<ID=UK,Number=1,Type=Integer,Description="Total number of unique kmers.">\n'
        '##INFO=<ID=AK,Number=R,Type=Integer,Description="Number of unique kmers per allele. '
        'Will be -1 for alleles not covered by any input haplotype path.">\n'
        '##INFO=<ID=MA,Number=1,Type=Integer,Description="Number of alleles missing in panel haplotypes.">\n'
        '##INFO=<ID=ID,Number=A,Type=String,Description="Variant IDs.">\n'
        '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">\n'
        '##FORMAT=<ID=KC,Number=1,Type=Float,Description="Local kmer coverage.">\n'
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t{sample}\n"
    )

    def _bulk_phasing_lines(
        self,
        genotyping_result: List[GenotypeLikelihoods],
        ignore_imputed: bool,
    ):
        """Vectorized GT:KC rendering for plain biallelic records
        (same eligibility rules as :meth:`_bulk_genotype_lines`)."""
        N = self.size()
        ok = np.zeros(N, dtype=bool)
        lines: List[Optional[str]] = [None] * N
        if N == 0:
            return ok, lines
        hdr = self.selection_header()
        P = hdr.paths.shape[1]
        size_for_af = P - 1 if self.add_reference else P
        if size_for_af <= 0:
            return ok, lines
        af1 = (hdr.paths == 1).sum(axis=1) / float(size_for_af)
        from ..io.sequence import contains_undefined

        chrom = self.chromosome
        variant_ids = self.variant_ids
        sep_counts = np.fromiter(
            (len(v.allele_sequences) for v in self.variants),
            dtype=np.int64, count=N,
        )
        counters = np.concatenate([[0], np.cumsum(sep_counts[:-1])]).tolist()
        starts1 = (hdr.starts + 1).tolist()
        af_l = af1.tolist()
        for i, variant in enumerate(self.variants):
            if len(variant.allele_sequences) != 1:
                continue
            seqs0 = variant.allele_sequences[0]
            if len(variant.allele_combinations) != 2:
                continue
            if contains_undefined(seqs0[0]) or contains_undefined(seqs0[1]):
                continue
            gl = genotyping_result[i]
            h1, h2 = gl.haplotype_1, gl.haplotype_2
            if not (0 <= h1 <= 1 and 0 <= h2 <= 1):
                continue
            if ignore_imputed and gl.nr_unique_kmers == 0:
                gt_field = "./."
            else:
                gt_field = f"{h1}|{h2}"
            ids = variant_ids[counters[i]]
            info = f"AF={af_l[i]:.6g};UK={gl.nr_unique_kmers};MA=0"
            if ids:
                info += ";ID=" + ",".join(ids)
            lines[i] = (
                f"{chrom}\t{starts1[i]}\t.\t"
                f"{seqs0[0].decode('ascii')}\t{seqs0[1].decode('ascii')}"
                f"\t.\tPASS\t{info}\tGT:KC\t{gt_field}:{gl.coverage}\n"
            )
            ok[i] = True
        return ok, lines

    def write_phasing(
        self,
        filename: str,
        genotyping_result: List[GenotypeLikelihoods],
        write_header: bool,
        sample: str,
        ignore_imputed: bool = False,
        bulk=None,
    ) -> None:
        """Emit the phased GT:KC VCF. (reference src/graph.cpp:280-415)"""
        if self.variants_deleted:
            raise RuntimeError(
                "ChromosomeGraph.write_phasing: variants were deleted; re-build object."
            )
        if len(genotyping_result) != self.size():
            raise RuntimeError(
                "ChromosomeGraph.write_phasing: number of variants and phasings differ."
            )
        fast_ok, fast_lines = self._bulk_phasing_lines(
            genotyping_result, ignore_imputed
        )
        if bulk is not None:
            # slow-path rows project likelihood dicts when alleles are
            # missing from the panel; give them the dict form back
            _materialize_bulk_rows(genotyping_result, bulk, fast_ok)
        mode = "w" if write_header else "a"
        with open(filename, mode) as out:
            if write_header:
                out.write(self._PH_HEADER.format(date=_current_date(), sample=sample))
            counter = 0
            for i in range(self.size()):
                if fast_ok[i]:
                    out.write(fast_lines[i])
                    counter += 1
                    continue
                variant = self.get_variant(i)
                coverage = genotyping_result[i].coverage
                nr_unique_kmers = genotyping_result[i].nr_unique_kmers
                singles, single_likelihoods = self._separated_records(
                    variant, genotyping_result[i]
                )
                for v, likelihoods in zip(singles, single_likelihoods):
                    v.remove_flanking_sequence()
                    nr_alleles = v.nr_of_alleles()
                    if nr_alleles < 2:
                        raise RuntimeError(
                            "ChromosomeGraph.write_phasing: <2 alleles at position "
                            f"{v.get_start_position()}"
                        )
                    alt_alleles = []
                    defined_alleles = [0]
                    for a in range(1, nr_alleles):
                        if not v.is_undefined_allele(a):
                            alt_alleles.append(v.get_allele_string(a))
                            defined_alleles.append(a)
                    nr_missing = nr_alleles - len(defined_alleles)
                    gl = likelihoods
                    if nr_missing > 0:
                        gl = likelihoods.get_specific_likelihoods(defined_alleles)

                    allele_freqs = v.all_allele_frequencies(self.add_reference)
                    af = ",".join(
                        _format_float(allele_freqs[a]) for a in defined_alleles[1:]
                    )
                    info = f"AF={af};UK={nr_unique_kmers};MA={nr_missing}"
                    if self.variant_ids[counter]:
                        info += ";ID=" + self._get_ids(alt_alleles, counter, False)

                    if ignore_imputed and nr_unique_kmers == 0:
                        gt_field = "./."
                    else:
                        hap1, hap2 = (
                            likelihoods.haplotype_1,
                            likelihoods.haplotype_2,
                        )
                        hap1_undefined = v.is_undefined_allele(hap1)
                        hap2_undefined = v.is_undefined_allele(hap2)
                        first = "." if hap1_undefined else str(gl.haplotype_1)
                        second = "." if hap2_undefined else str(gl.haplotype_2)
                        gt_field = f"{first}|{second}"
                    out.write(
                        f"{v.chromosome}\t{v.get_start_position() + 1}\t.\t"
                        f"{v.get_allele_string(0)}\t{','.join(alt_alleles)}\t.\tPASS\t"
                        f"{info}\tGT:KC\t{gt_field}:{coverage}\n"
                    )
                    counter += 1

    _PANEL_HEADER = (
        "##fileformat=VCFv4.2\n"
        "##fileDate={date}\n"
        '##INFO=<ID=AF,Number=A,Type=Float,Description="Allele Frequency">\n'
        '##INFO=<ID=UK,Number=1,Type=Integer,Description="Total number of unique kmers.">\n'
        '##INFO=<ID=MA,Number=1,Type=Integer,Description="Number of alleles missing in panel haplotypes.">\n'
        '##INFO=<ID=ID,Number=A,Type=String,Description="Variant IDs.">\n'
        '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">\n'
    )

    def write_sampled_panel(
        self,
        filename: str,
        sampled_paths: List[SampledPanel],
        write_header: bool,
    ) -> None:
        """Emit the multi-sample sampled-panel VCF.

        (reference src/graph.cpp:418-551)
        """
        if self.variants_deleted:
            raise RuntimeError(
                "ChromosomeGraph.write_sampled_panel: variants were deleted; re-build object."
            )
        if len(sampled_paths) != self.size():
            raise RuntimeError(
                "ChromosomeGraph.write_sampled_panel: number of variants and panels differ."
            )
        mode = "w" if write_header else "a"
        with open(filename, mode) as out:
            if write_header:
                out.write(self._PANEL_HEADER.format(date=_current_date()))
                nr_paths = len(sampled_paths[0].path_to_allele)
                cols = "\t".join(f"sampledHT{i}" for i in range(nr_paths))
                out.write(
                    "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t" + cols + "\n"
                )
            counter = 0
            for i in range(self.size()):
                variant = self.get_variant(i)
                nr_unique_kmers = sampled_paths[i].nr_unique_kmers
                singles, single_sampled = self._separated_records(
                    variant, sampled_paths[i]
                )
                for v, sampled in zip(singles, single_sampled):
                    v.remove_flanking_sequence()
                    nr_alleles = v.nr_of_alleles()
                    if nr_alleles < 2:
                        raise RuntimeError(
                            "ChromosomeGraph.write_sampled_panel: <2 alleles at "
                            f"position {v.get_start_position()}"
                        )
                    alt_alleles = []
                    defined_alleles = [0]
                    for a in range(1, nr_alleles):
                        if not v.is_undefined_allele(a):
                            alt_alleles.append(v.get_allele_string(a))
                            defined_alleles.append(a)
                    nr_missing = nr_alleles - len(defined_alleles)
                    paths = sampled
                    if nr_missing > 0:
                        paths = sampled.get_specific_alleles(defined_alleles)
                    allele_freqs = v.all_allele_frequencies(self.add_reference)
                    af = ",".join(
                        _format_float(allele_freqs[a]) for a in defined_alleles[1:]
                    )
                    info = f"AF={af};UK={nr_unique_kmers};MA={nr_missing}"
                    if self.variant_ids[counter]:
                        info += ";ID=" + self._get_ids(alt_alleles, counter, False)
                    gt_cols = []
                    for p, allele in enumerate(paths.path_to_allele):
                        if v.is_undefined_allele(sampled.path_to_allele[p]):
                            assert allele == -1
                            gt_cols.append(".")
                        else:
                            gt_cols.append(str(allele))
                    out.write(
                        f"{v.chromosome}\t{v.get_start_position() + 1}\t.\t"
                        f"{v.get_allele_string(0)}\t{','.join(alt_alleles)}\t.\tPASS\t"
                        f"{info}\tGT\t" + "\t".join(gt_cols) + "\n"
                    )
                    counter += 1
