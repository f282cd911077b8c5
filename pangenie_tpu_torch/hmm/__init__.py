"""Pair-HMM genotyping and haplotype sampling on torch tensors."""
