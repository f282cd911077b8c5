"""Variant bubbles: clustering-merged multi-allelic pangenome bubbles.

Host-side data model replacing the reference's ``Variant`` class
(src/variant.cpp:52-641). A bubble stores:

- k-1 bp left/right flanks,
- per sub-variant allele sequences (``allele_sequences[v][a]``),
- merged-allele -> per-sub-variant allele ids (``allele_combinations``),
- reference sequence between merged sub-variants (``inner_flanks``),
- per sub-variant list of alleles uncovered by any path,
- ``paths``: path index -> merged allele id.

Merging two bubbles enumerates observed (left, right) allele pairs over
paths plus a forced REF-REF allele, ordered by (left, right) id
(reference src/variant.cpp:238-306). Separation projects merged
genotype likelihoods back onto each sub-variant
(src/variant.cpp:308-391).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from ..io.sequence import contains_undefined


@dataclass
class GenotypeLikelihoods:
    """Per-variant genotyping result.

    Mirrors GenotypingResult (src/genotypingresult.cpp): a sparse map of
    unordered allele pairs (a1 <= a2) -> likelihood, the Viterbi
    haplotype pair, local coverage and unique-kmer count.
    """

    likelihoods: Dict[Tuple[int, int], float] = field(default_factory=dict)
    haplotype_1: int = 0
    haplotype_2: int = 0
    coverage: int = 0
    nr_unique_kmers: int = 0

    def add_to_likelihood(self, a1: int, a2: int, value: float) -> None:
        # values are held as np.longdouble (80-bit on x86-64) so that
        # accumulation/normalization matches the reference's long double
        # arithmetic; device math is f64, but host-side bookkeeping must
        # not round e.g. 1 - 1e-19 to 1.0 (GQ depends on the difference)
        import numpy as np

        key = (a1, a2) if a1 < a2 else (a2, a1)
        self.likelihoods[key] = self.likelihoods.get(
            key, np.longdouble(0.0)
        ) + np.longdouble(value)

    def get_genotype_likelihood(self, a1: int, a2: int) -> float:
        key = (a1, a2) if a1 < a2 else (a2, a1)
        return self.likelihoods.get(key, 0.0)

    def contains_no_likelihoods(self) -> bool:
        return not self.likelihoods

    def normalize(self) -> None:
        """Normalize likelihoods to sum 1 (src/genotypingresult.cpp:200-210).

        The dominant entry is computed as 1/(1 + rest/v) rather than
        v/total: device posteriors are f64 promoted to longdouble, and
        the reciprocal form reproduces the reference's long-double
        rounding of near-certain probabilities (1 - ~1e-19) at the final
        ulp, which the GL/GQ output formatting exposes.
        """
        import numpy as np

        total = sum(self.likelihoods.values())
        if total > 0:
            vmax = max(self.likelihoods.values())
            for k, v in self.likelihoods.items():
                if v == vmax and v > 0:
                    rest = (total - v) / v
                    self.likelihoods[k] = np.longdouble(1.0) / (
                        np.longdouble(1.0) + rest
                    )
                else:
                    self.likelihoods[k] = v / total

    def divide_likelihoods_by(self, value: float) -> None:
        """(reference src/genotypingresult.cpp:99-103)"""
        for k in self.likelihoods:
            self.likelihoods[k] = self.likelihoods[k] / value

    def combine(self, other: "GenotypeLikelihoods") -> None:
        for k, v in other.likelihoods.items():
            self.likelihoods[k] = self.likelihoods.get(k, 0.0) + v

    def get_all_likelihoods(self, nr_alleles: int) -> List[float]:
        """Dense VCF-ordered GL vector, index = a2*(a2+1)/2 + a1.

        (reference src/genotypingresult.cpp:48-67)
        """
        result = [0.0] * ((nr_alleles * (nr_alleles + 1)) // 2)
        for (a1, a2), v in self.likelihoods.items():
            index = (a2 * (a2 + 1)) // 2 + a1
            if index >= len(result):
                raise RuntimeError(
                    "GenotypeLikelihoods: genotype does not match number of alleles."
                )
            result[index] = v
        return result

    def get_specific_likelihoods(
        self, alleles: Sequence[int]
    ) -> "GenotypeLikelihoods":
        """Re-index onto the provided allele subset and normalize.

        (reference src/genotypingresult.cpp:70-96)
        """
        result = GenotypeLikelihoods()
        keep = set(alleles)
        index = {a: i for i, a in enumerate(alleles)}
        total = 0.0
        for (a1, a2), v in sorted(self.likelihoods.items()):
            if a1 not in keep or a2 not in keep:
                continue
            i, j = index[a1], index[a2]
            if self.haplotype_1 == a1:
                result.haplotype_1 = i
            if self.haplotype_2 == a2:
                result.haplotype_2 = j
            result.add_to_likelihood(i, j, v)
            total += v
        if total > 0:
            for k in result.likelihoods:
                result.likelihoods[k] /= total
        result.coverage = self.coverage
        result.nr_unique_kmers = self.nr_unique_kmers
        return result

    def get_likeliest_genotype(self) -> Tuple[int, int]:
        """Likeliest genotype; (-1, -1) when absent/zero/non-unique.

        The reference iterates the (ordered) map taking `>=`, i.e. the
        LAST maximal genotype in (a1, a2) sorted order, then requires a
        unique maximum within 1e-10 (src/genotypingresult.cpp:149-180).
        """
        if not self.likelihoods:
            return (-1, -1)
        best_value = 0.0
        best_genotype = (0, 0)
        for gt, v in sorted(self.likelihoods.items()):
            if v >= best_value:
                best_value = v
                best_genotype = gt
        for gt, v in sorted(self.likelihoods.items()):
            if gt != best_genotype and abs(v - best_value) < 1e-10:
                return (-1, -1)
        if best_value > 0.0:
            return best_genotype
        return (-1, -1)

    def get_genotype_quality(self, a1: int, a2: int) -> int:
        """Phred-scaled GQ = -10*log10(1 - P(gt)), 10000 if P(gt)==1.

        Requires normalized likelihoods (src/genotypingresult.cpp:118-137).
        Computed in 80-bit extended precision (np.longdouble on x86-64)
        to match the reference's long double — near-certain genotypes
        have 1 - P(gt) ~ 1e-19, which float64 rounds away.
        """
        import numpy as np

        total = sum(self.likelihoods.values())
        if abs(total - 1.0) > 1e-10:
            raise RuntimeError(
                "GenotypeLikelihoods: genotype quality requires normalized likelihoods."
            )
        prob_wrong = np.longdouble(1.0) - self.get_genotype_likelihood(a1, a2)
        if prob_wrong > 0.0:
            return int(-10 * np.log10(prob_wrong))
        return 10000


@dataclass
class VariantStats:
    """Per-variant allele statistics (reference src/variant.hpp:20-27)."""

    nr_unique_kmers: int = 0
    coverage: int = 0
    kmer_counts: Dict[int, int] = field(default_factory=dict)


@dataclass
class SampledPanel:
    """Per-column path -> allele snapshot for sampled-panel VCF output.

    (reference src/sampledpanel.cpp)
    """

    path_to_allele: List[int]
    nr_unique_kmers: int = 0

    def get_specific_alleles(self, alleles: Sequence[int]) -> "SampledPanel":
        index = {a: i for i, a in enumerate(alleles)}
        updated = [index.get(a, -1) for a in self.path_to_allele]
        return SampledPanel(updated, self.nr_unique_kmers)


class VariantBubble:
    """A (possibly merged) variant bubble. See module docstring."""

    def __init__(
        self,
        left_flank: bytes,
        right_flank: bytes,
        chromosome: str,
        start_position: int,
        end_position: int,
        alleles: Sequence[bytes],
        paths: Sequence[int],
    ):
        if len(alleles) > 65535:
            raise RuntimeError("VariantBubble: number of alleles exceeds 65535.")
        if len(paths) > 65535:
            raise RuntimeError("VariantBubble: number of paths exceeds 65535.")
        self.left_flank = left_flank
        self.right_flank = right_flank
        self.chromosome = chromosome
        self.start_position = start_position
        self.paths: List[int] = list(paths)
        self.flanks_added = False
        self.allele_sequences: List[List[bytes]] = [list(alleles)]
        self.allele_combinations: List[Tuple[int, ...]] = [
            (i,) for i in range(len(alleles))
        ]
        self.inner_flanks: List[bytes] = []
        self.uncovered_alleles: List[List[int]] = []
        self._set_values(end_position)

    @classmethod
    def trusted(
        cls,
        left_flank: bytes,
        right_flank: bytes,
        chromosome: str,
        start_position: int,
        end_position: int,
        alleles: List[bytes],
        paths: List[int],
        uncovered: List[int],
    ) -> "VariantBubble":
        """Construct without re-validating: the native VCF scanner
        (csrc pg_parse_vcf_chunk) has already performed every check in
        :meth:`_set_values` (flank symmetry, end>start, ref length,
        path-allele bounds) and computed the uncovered-allele list.
        ``alleles`` and ``paths`` are owned by the new object."""
        self = cls.__new__(cls)
        self.left_flank = left_flank
        self.right_flank = right_flank
        self.chromosome = chromosome
        self.start_position = start_position
        self.paths = paths
        self.flanks_added = False
        self.allele_sequences = [alleles]
        self.allele_combinations = [(i,) for i in range(len(alleles))]
        self.inner_flanks = []
        self.uncovered_alleles = [uncovered]
        return self

    def _set_values(self, end_position: int) -> None:
        covered = set(self.paths)
        uncovered = [
            i for i in range(len(self.allele_sequences[0])) if i not in covered
        ]
        self.uncovered_alleles.append(uncovered)
        if len(self.left_flank) != len(self.right_flank):
            raise RuntimeError(
                "VariantBubble: left and right flanks have different sizes."
            )
        if end_position <= self.start_position:
            raise RuntimeError(
                "VariantBubble: end position is smaller or equal to start position."
            )
        ref_len = len(self.allele_sequences[0][0])
        if ref_len != end_position - self.start_position:
            raise RuntimeError(
                "VariantBubble: end position does not match length of reference allele."
            )
        nr_alleles = len(self.allele_sequences[0])
        for p in self.paths:
            if p >= nr_alleles:
                raise RuntimeError(
                    "VariantBubble: allele ids given in paths are invalid."
                )

    # -- basic queries ---------------------------------------------------

    def nr_of_alleles(self) -> int:
        return len(self.allele_combinations)

    def nr_of_paths(self) -> int:
        return len(self.paths)

    def is_combined(self) -> bool:
        return len(self.allele_sequences) > 1

    def get_start_position(self) -> int:
        return self.start_position

    def get_end_position(self) -> int:
        end = self.start_position
        for i, seqs in enumerate(self.allele_sequences):
            end += len(seqs[0])
            if i < len(self.allele_sequences) - 1:
                end += len(self.inner_flanks[i])
        return end

    def add_flanking_sequence(self) -> None:
        self.flanks_added = True

    def remove_flanking_sequence(self) -> None:
        self.flanks_added = False

    def get_allele_sequence(self, index: int) -> bytes:
        """Full sequence of merged allele `index` (with flanks if added).

        (reference src/variant.cpp:159-201)
        """
        if index >= len(self.allele_combinations):
            raise RuntimeError("VariantBubble.get_allele_sequence: index out of bounds.")
        parts: List[bytes] = []
        if self.flanks_added:
            parts.append(self.left_flank)
        combo = self.allele_combinations[index]
        for i, a in enumerate(combo):
            parts.append(self.allele_sequences[i][a])
            if i < len(combo) - 1:
                parts.append(self.inner_flanks[i])
        if self.flanks_added:
            parts.append(self.right_flank)
        return b"".join(parts)

    def get_allele_string(self, index: int) -> str:
        return self.get_allele_sequence(index).decode("ascii")

    def selection_alleles(self) -> Tuple[List[bytes], List[bool]]:
        """(sequence, is_undefined) for every merged allele, one call.

        Equivalent to calling :meth:`get_allele_sequence` and
        :meth:`is_undefined_allele` per allele (the unique-kmer
        selection header pattern, reference
        src/uniquekmercomputer.cpp:125-134) without per-allele method
        dispatch; undefined-ness is judged on the sub-variant allele
        sequences only, exactly as :meth:`is_undefined_allele` does.
        """
        lf, rf = self.left_flank, self.right_flank
        flanked = self.flanks_added
        if len(self.allele_sequences) == 1:
            seqs0 = self.allele_sequences[0]
            undef = [contains_undefined(s) for s in seqs0]
            if flanked:
                seqs = [lf + s + rf for s in seqs0]
            else:
                seqs = list(seqs0)
            return seqs, undef
        seqs: List[bytes] = []
        undef: List[bool] = []
        inner = self.inner_flanks
        nv = len(self.allele_sequences)
        for combo in self.allele_combinations:
            parts = [lf] if flanked else []
            u = False
            for i, a in enumerate(combo):
                sub = self.allele_sequences[i][a]
                u = u or contains_undefined(sub)
                parts.append(sub)
                if i < nv - 1:
                    parts.append(inner[i])
            if flanked:
                parts.append(rf)
            seqs.append(b"".join(parts))
            undef.append(u)
        return seqs, undef

    def get_allele_on_path(self, path_index: int) -> int:
        return self.paths[path_index]

    def get_paths_of_allele(self, allele_index: int) -> List[int]:
        return [i for i, a in enumerate(self.paths) if a == allele_index]

    def is_undefined_allele(self, allele_id: int) -> bool:
        """True if any sub-variant allele of this merged allele has N.

        (reference src/variant.cpp:625-632)
        """
        for i, a in enumerate(self.allele_combinations[allele_id]):
            if contains_undefined(self.allele_sequences[i][a]):
                return True
        return False

    def nr_missing_alleles(self) -> int:
        missing = 0
        for path_allele in self.paths:
            if contains_undefined(self.get_allele_sequence(path_allele)):
                missing += 1
        return missing

    def allele_frequency(self, allele_index: int, ignore_ref_path: bool) -> float:
        if not self.paths:
            return 0.0
        freq = float(sum(1 for a in self.paths if a == allele_index))
        size = len(self.paths)
        if ignore_ref_path:
            size -= 1
            if allele_index == 0:
                freq -= 1.0
        return freq / size

    def all_allele_frequencies(self, ignore_ref_path: bool) -> List[float]:
        result = [0.0] * self.nr_of_alleles()
        for a in self.paths:
            result[a] += 1.0
        size = len(self.paths)
        if ignore_ref_path:
            size -= 1
            result[0] -= 1.0
        return [r / size for r in result]

    # -- merging ---------------------------------------------------------

    def combine_variants(self, v2: "VariantBubble") -> None:
        """Merge neighbouring bubble `v2` into this one (in place).

        (reference src/variant.cpp:238-306)
        """
        end_position = self.get_end_position()
        if v2.get_start_position() < end_position:
            raise RuntimeError("VariantBubble.combine_variants: variants are overlapping.")
        if self.flanks_added or v2.flanks_added:
            raise RuntimeError(
                "VariantBubble.combine_variants: only flankless variants can be combined."
            )
        k1, k2 = len(self.left_flank), len(v2.left_flank)
        if k1 != k2:
            raise RuntimeError("VariantBubble.combine_variants: kmersizes differ.")
        dist = v2.get_start_position() - end_position
        if dist > k1 or self.chromosome != v2.chromosome:
            raise RuntimeError(
                "VariantBubble.combine_variants: variants are more than kmersize apart."
            )
        if len(self.paths) != len(v2.paths):
            raise RuntimeError(
                "VariantBubble.combine_variants: variants not covered by the same paths."
            )

        # enumerate (left allele, right allele) pairs observed on paths
        path_to_index: Dict[Tuple[int, int], List[int]] = {}
        for p, (la, ra) in enumerate(zip(self.paths, v2.paths)):
            path_to_index.setdefault((la, ra), []).append(p)
        # forced REF-REF allele
        path_to_index.setdefault((0, 0), [])

        if len(path_to_index) > 65535:
            raise RuntimeError("VariantBubble.combine_variants: too many merged alleles.")

        new_paths = [0] * len(self.paths)
        new_alleles: List[Tuple[int, ...]] = []
        # iterate in sorted (left, right) order as the reference's std::map does
        for allele_index, (la_ra, path_list) in enumerate(sorted(path_to_index.items())):
            la, ra = la_ra
            for p in path_list:
                new_paths[p] = allele_index
            new_alleles.append(self.allele_combinations[la] + v2.allele_combinations[ra])

        # reference sequence between the two bubbles comes from this
        # bubble's right flank prefix
        self.inner_flanks.append(self.right_flank[:dist])
        self.inner_flanks.extend(v2.inner_flanks)

        self.right_flank = v2.right_flank
        self.allele_combinations = new_alleles
        self.allele_sequences.extend(v2.allele_sequences)
        self.uncovered_alleles.extend(v2.uncovered_alleles)
        self.paths = new_paths

    # -- separation ------------------------------------------------------

    def _paths_per_subvariant(self) -> List[List[int]]:
        import numpy as np

        nr_variants = len(self.allele_sequences)
        # combos is rectangular: every merged allele maps to exactly one
        # allele per sub-variant
        combos = np.asarray(self.allele_combinations, dtype=np.int64)
        assert combos.shape[1] == nr_variants
        sel = combos[np.asarray(self.paths, dtype=np.int64)]  # [P, V]
        return [sel[:, v].tolist() for v in range(nr_variants)]

    def _reference_allele_parts(self) -> List[bytes]:
        """[left_flank, ref0, inner0, ref1, ..., right_flank]."""
        nr_variants = len(self.allele_sequences)
        parts: List[bytes] = []
        for i in range(nr_variants):
            allele_id = self.allele_combinations[0][i]
            parts.append(self.allele_sequences[i][allele_id])
            if i < nr_variants - 1:
                parts.append(self.inner_flanks[i])
        return [self.left_flank] + parts + [self.right_flank]

    @staticmethod
    def _construct_left_flank(parts: List[bytes], position: int, length: int) -> bytes:
        joined = b"".join(parts[:position])
        if len(joined) < length:
            joined = joined  # reference stops when bases run out
        return joined[-length:] if length > 0 else b""

    @staticmethod
    def _construct_right_flank(parts: List[bytes], position: int, length: int) -> bytes:
        joined = b"".join(parts[position + 1 :])
        if len(joined) < length:
            raise RuntimeError(
                "VariantBubble: not enough bases given at right side."
            )
        return joined[:length]

    def separate_variants(
        self,
        input_genotyping: Optional[GenotypeLikelihoods] = None,
        skip_flanks: bool = False,
    ) -> Tuple[List["VariantBubble"], List[GenotypeLikelihoods]]:
        """Undo merging: one VariantBubble (and projected likelihoods)
        per sub-variant. (reference src/variant.cpp:308-391)
        """
        nr_variants = len(self.allele_sequences)
        paths_per_variant = self._paths_per_subvariant()
        reference_allele = [] if skip_flanks else self._reference_allele_parts()

        resulting_variants: List[VariantBubble] = []
        resulting_genotyping: List[GenotypeLikelihoods] = []
        current_start = self.start_position
        for i in range(nr_variants):
            if skip_flanks:
                left = b""
                right = b""
            else:
                left = self._construct_left_flank(
                    reference_allele, i * 2 + 1, len(self.left_flank)
                )
                right = self._construct_right_flank(
                    reference_allele, i * 2 + 1, len(self.right_flank)
                )
            alleles = self.allele_sequences[i]
            current_end = current_start + len(alleles[0])
            v = VariantBubble(
                left,
                right,
                self.chromosome,
                current_start,
                current_end,
                alleles,
                paths_per_variant[i],
            )
            resulting_variants.append(v)
            if input_genotyping is not None:
                g = GenotypeLikelihoods()
                precomputed = [
                    self.allele_combinations[a0][i]
                    for a0 in range(self.nr_of_alleles())
                ]
                if not input_genotyping.contains_no_likelihoods():
                    for (a1, a2), value in sorted(
                        input_genotyping.likelihoods.items()
                    ):
                        g.add_to_likelihood(precomputed[a1], precomputed[a2], value)
                h1, h2 = (
                    input_genotyping.haplotype_1,
                    input_genotyping.haplotype_2,
                )
                g.haplotype_1 = precomputed[h1]
                g.haplotype_2 = precomputed[h2]
                g.coverage = input_genotyping.coverage
                g.nr_unique_kmers = input_genotyping.nr_unique_kmers
                resulting_genotyping.append(g)
            current_start = current_end
            if i < nr_variants - 1:
                current_start += len(self.inner_flanks[i])
        return resulting_variants, resulting_genotyping

    def separate_variants_panel(
        self, input_sampling: Optional[SampledPanel] = None, skip_flanks: bool = False
    ) -> Tuple[List["VariantBubble"], List[SampledPanel]]:
        """Like separate_variants, for SampledPanel columns.

        (reference src/variant.cpp:394-471)
        """
        nr_variants = len(self.allele_sequences)
        paths_per_variant = self._paths_per_subvariant()
        reference_allele = [] if skip_flanks else self._reference_allele_parts()

        resulting_variants: List[VariantBubble] = []
        resulting_sampling: List[SampledPanel] = []
        current_start = self.start_position
        for i in range(nr_variants):
            if skip_flanks:
                left = b""
                right = b""
            else:
                left = self._construct_left_flank(
                    reference_allele, i * 2 + 1, len(self.left_flank)
                )
                right = self._construct_right_flank(
                    reference_allele, i * 2 + 1, len(self.right_flank)
                )
            alleles = self.allele_sequences[i]
            current_end = current_start + len(alleles[0])
            v = VariantBubble(
                left,
                right,
                self.chromosome,
                current_start,
                current_end,
                alleles,
                paths_per_variant[i],
            )
            resulting_variants.append(v)
            if input_sampling is not None:
                precomputed = [
                    self.allele_combinations[a0][i]
                    for a0 in range(self.nr_of_alleles())
                ]
                single = [
                    precomputed[input_sampling.path_to_allele[p]]
                    for p in range(len(input_sampling.path_to_allele))
                ]
                resulting_sampling.append(
                    SampledPanel(single, input_sampling.nr_unique_kmers)
                )
            current_start = current_end
            if i < nr_variants - 1:
                current_start += len(self.inner_flanks[i])
        return resulting_variants, resulting_sampling

    def variant_statistics(self, unique_kmers) -> List["VariantStats"]:
        """Per-sub-variant allele kmer counts; -1 for uncovered alleles.

        (reference src/variant.cpp:474-507)
        """
        nr_variants = len(self.allele_sequences)
        assert len(self.uncovered_alleles) == nr_variants
        kmers_per_allele = unique_kmers.kmers_on_alleles()
        result = []
        for i in range(nr_variants):
            new_kmer_counts: Dict[int, int] = {}
            for a0 in range(self.nr_of_alleles()):
                single = self.allele_combinations[a0][i]
                new_kmer_counts[single] = new_kmer_counts.get(
                    single, 0
                ) + kmers_per_allele.get(a0, 0)
            for u in self.uncovered_alleles[i]:
                new_kmer_counts[u] = -1
            result.append(
                VariantStats(
                    nr_unique_kmers=unique_kmers.size(),
                    coverage=unique_kmers.get_coverage(),
                    kmer_counts=new_kmer_counts,
                )
            )
        return result

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, VariantBubble):
            return NotImplemented
        return (
            self.left_flank == other.left_flank
            and self.right_flank == other.right_flank
            and self.chromosome == other.chromosome
            and self.start_position == other.start_position
            and self.get_end_position() == other.get_end_position()
            and self.allele_sequences == other.allele_sequences
            and self.allele_combinations == other.allele_combinations
            and self.inner_flanks == other.inner_flanks
            and self.uncovered_alleles == other.uncovered_alleles
            and self.paths == other.paths
            and self.flanks_added == other.flanks_added
        )
