"""Evaluation tools: genotype concordance, benchmarks."""

from .concordance import genotype_concordance

__all__ = ["genotype_concordance"]
