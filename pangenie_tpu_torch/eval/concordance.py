"""Genotype concordance against a truth set.

The north-star quality metric (the reference ships offline evaluators
in scripts/genotype-concordance*.py; this is the in-package
equivalent): fraction of variant records whose called unordered
genotype equals the truth genotype, with per-class breakdown.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple


@dataclass
class ConcordanceResult:
    total: int = 0
    correct: int = 0
    no_call: int = 0
    wrong: int = 0
    by_class: Dict[str, Tuple[int, int]] = field(default_factory=dict)

    @property
    def concordance(self) -> float:
        return self.correct / self.total if self.total else 0.0


def _classify(ref: str, alts: str) -> str:
    alleles = [ref] + alts.split(",")
    if len(alleles) > 2:
        return "multiallelic"
    if all(len(a) == 1 for a in alleles):
        return "snp"
    return "indel"


def parse_genotypes(vcf_path: str) -> Dict[Tuple[str, int], dict]:
    """(chromosome, position 1-based) -> {'gt': (a, b) | None,
    'class': str}. Keying by position alone collided across
    chromosomes at genome scale (silently dropping records and pairing
    truth/call entries from different chromosomes — ~0.2% spurious
    discordance at the 50 Mb / 5-chromosome workload)."""
    result = {}
    with open(vcf_path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            tokens = line.rstrip("\n").split("\t")
            gt_field = tokens[9].split(":")[0]
            if "." in gt_field:
                gt: Optional[Tuple[int, int]] = None
            else:
                sep = "|" if "|" in gt_field else "/"
                a, b = (int(x) for x in gt_field.split(sep))
                gt = tuple(sorted((a, b)))
            result[(tokens[0], int(tokens[1]))] = {
                "gt": gt,
                "class": _classify(tokens[3], tokens[4]),
            }
    return result


def genotype_concordance(
    called_vcf: str, truth_vcf: str
) -> ConcordanceResult:
    """Compare the single-sample genotype columns of two VCFs by
    position; truth records missing from the call set count as
    no-calls."""
    called = parse_genotypes(called_vcf)
    truth = parse_genotypes(truth_vcf)

    result = ConcordanceResult()
    for pos, t in truth.items():
        result.total += 1
        cls = t["class"]
        hit, tot = result.by_class.get(cls, (0, 0))
        c = called.get(pos)
        if c is None or c["gt"] is None:
            result.no_call += 1
            result.by_class[cls] = (hit, tot + 1)
            continue
        if c["gt"] == t["gt"]:
            result.correct += 1
            result.by_class[cls] = (hit + 1, tot + 1)
        else:
            result.wrong += 1
            result.by_class[cls] = (hit, tot + 1)
    return result
