"""Synthetic pangenome workload generation.

Produces (reference FASTA, phased panel VCF, read set, truth
genotypes) tuples for end-to-end tests and benchmarks — the
counterpart of the reference's demo/pipeline data at arbitrary scale.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def random_reference(length: int, rng: np.random.Generator) -> bytes:
    return _BASES[rng.integers(0, 4, length)].tobytes()


@dataclass
class SimVariant:
    position: int            # 0-based
    ref: bytes
    alts: List[bytes]
    genotypes: List[Tuple[int, int]]  # phased, per sample


def _random_allele(rng, ref_base: bytes, kind: str) -> bytes:
    if kind == "snp":
        choices = [b for b in b"ACGT" if bytes([b]) != ref_base]
        return bytes([choices[rng.integers(0, 3)]])
    if kind == "ins":
        length = int(rng.integers(1, 8))
        return ref_base + _BASES[rng.integers(0, 4, length)].tobytes()
    raise AssertionError(kind)


def simulate_panel(
    reference: bytes,
    nr_samples: int,
    rng: np.random.Generator,
    mean_distance: int = 400,
    kmer_size: int = 31,
    multiallelic_fraction: float = 0.15,
    insertion_fraction: float = 0.2,
    cluster_fraction: float = 0.0,
    sv_fraction: float = 0.0,
    sv_length: int = 200,
) -> List[SimVariant]:
    """Plant biallelic SNPs / insertions and occasional multi-allelic
    sites with random phased genotypes; variants stay > 2k from the
    chromosome ends. ``cluster_fraction`` plants a second variant
    < k-1 bp downstream (exercising bubble merging/separation);
    ``sv_fraction`` plants large (~sv_length bp) insertions."""
    variants: List[SimVariant] = []
    pos = 2 * kmer_size + int(rng.integers(0, mean_distance))
    end_limit = len(reference) - 2 * kmer_size - 10
    while pos < end_limit:
        ref_base = reference[pos : pos + 1]
        r = rng.random()
        if r < sv_fraction:
            length = int(rng.integers(sv_length // 2, 2 * sv_length))
            ref_seq = ref_base
            alts = [ref_base + _BASES[rng.integers(0, 4, length)].tobytes()]
        elif r < sv_fraction + multiallelic_fraction:
            # deletion-style multiallelic: REF spans several bases
            span = int(rng.integers(2, 6))
            ref_seq = reference[pos : pos + span]
            alts = [ref_seq[:1], _random_allele(rng, ref_seq[:1], "snp") + ref_seq[1:]]
        elif r < sv_fraction + multiallelic_fraction + insertion_fraction:
            ref_seq = ref_base
            alts = [_random_allele(rng, ref_base, "ins")]
        else:
            ref_seq = ref_base
            alts = [_random_allele(rng, ref_base, "snp")]

        variants.append(
            SimVariant(pos, ref_seq, alts,
                       _random_genotypes(rng, len(alts) + 1, nr_samples))
        )
        if rng.random() < cluster_fraction:
            # companion SNP < k-1 bp away -> same merged bubble
            gap = int(rng.integers(2, kmer_size - 2))
            snp_pos = variants[-1].position + len(ref_seq) + gap
            if snp_pos < end_limit:
                snp_ref = reference[snp_pos : snp_pos + 1]
                variants.append(
                    SimVariant(
                        snp_pos, snp_ref,
                        [_random_allele(rng, snp_ref, "snp")],
                        _random_genotypes(rng, 2, nr_samples),
                    )
                )
                pos = snp_pos + 1
        pos += len(ref_seq) + kmer_size + int(
            rng.integers(0, 2 * mean_distance)
        )
    return variants


def _random_genotypes(rng, nr_alleles, nr_samples):
    freqs = rng.dirichlet(np.ones(nr_alleles) * 0.8)
    genotypes = [
        (
            int(rng.choice(nr_alleles, p=freqs)),
            int(rng.choice(nr_alleles, p=freqs)),
        )
        for _ in range(nr_samples)
    ]
    # ensure at least one non-ref haplotype so the record survives
    if all(g == (0, 0) for g in genotypes):
        genotypes[0] = (1, genotypes[0][1])
    return genotypes


def write_inputs(
    outdir: str,
    reference: bytes,
    variants: Sequence[SimVariant],
    chromosome: str = "chr1",
) -> Tuple[str, str]:
    """Write reference FASTA + phased panel VCF; returns their paths."""
    fasta = os.path.join(outdir, "ref.fa")
    with open(fasta, "w") as out:
        out.write(f">{chromosome}\n")
        seq = reference.decode()
        for i in range(0, len(seq), 80):
            out.write(seq[i : i + 80] + "\n")

    vcf = os.path.join(outdir, "panel.vcf")
    nr_samples = len(variants[0].genotypes) if variants else 0
    with open(vcf, "w") as out:
        out.write("##fileformat=VCFv4.2\n")
        out.write(f"##contig=<ID={chromosome}>\n")
        samples = "\t".join(f"S{i}" for i in range(nr_samples))
        out.write(
            "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
            + samples + "\n"
        )
        for v in variants:
            gts = "\t".join(f"{a}|{b}" for a, b in v.genotypes)
            out.write(
                f"{chromosome}\t{v.position + 1}\t.\t{v.ref.decode()}\t"
                f"{','.join(a.decode() for a in v.alts)}\t.\tPASS\t.\tGT\t"
                + gts + "\n"
            )
    return fasta, vcf


def haplotype_sequences(
    reference: bytes, variants: Sequence[SimVariant], sample: int
) -> Tuple[bytes, bytes]:
    """Apply the sample's two phased haplotypes to the reference."""
    haps = []
    for h in range(2):
        parts = []
        prev = 0
        for v in variants:
            parts.append(reference[prev : v.position])
            allele = v.genotypes[sample][h]
            seq = v.ref if allele == 0 else v.alts[allele - 1]
            parts.append(seq)
            prev = v.position + len(v.ref)
        parts.append(reference[prev:])
        haps.append(b"".join(parts))
    return haps[0], haps[1]


def simulate_reads_to_file(
    hap1: bytes,
    hap2: bytes,
    coverage: float,
    read_length: int,
    rng: np.random.Generator,
    out,
    error_rate: float = 0.001,
) -> int:
    """Vectorized read simulation written straight to an open file.

    The list-of-bytes path materializes millions of Python objects and
    per-read strings; genome-scale benches only need the FASTA bytes.
    All reads share the header line ">r" (parsers ignore names).
    Returns the number of reads written.
    """
    total_bases = int(coverage * (len(hap1) + len(hap2)) / 2)
    nr_reads = max(1, total_bases // read_length)
    haps = [np.frombuffer(h, np.uint8) for h in (hap1, hap2)]
    assert len(hap1) > read_length and len(hap2) > read_length
    pick = rng.random(nr_reads) < 0.5
    window = np.arange(read_length)[None, :]
    arr = np.empty((nr_reads, read_length), np.uint8)
    for h, mask in ((0, pick), (1, ~pick)):
        n = int(mask.sum())
        if n == 0:
            continue
        hap = haps[h]
        starts = rng.integers(0, len(hap) - read_length, size=n)
        arr[mask] = hap[starts[:, None] + window]
    errors = rng.random(arr.shape) < error_rate
    n_err = int(errors.sum())
    if n_err:
        arr[errors] = _BASES[rng.integers(0, 4, n_err)]
    comp_lut = np.zeros(256, np.uint8)
    comp_lut[np.frombuffer(b"ACGT", np.uint8)] = np.frombuffer(
        b"TGCA", np.uint8
    )
    flip = rng.random(nr_reads) < 0.5
    arr[flip] = comp_lut[arr[flip]][:, ::-1]
    # one [N, 3 + L + 1] byte matrix: ">r\n" + read + "\n"
    block = np.empty((nr_reads, read_length + 4), np.uint8)
    block[:, 0] = ord(">")
    block[:, 1] = ord("r")
    block[:, 2] = ord("\n")
    block[:, 3:-1] = arr
    block[:, -1] = ord("\n")
    out.write(block.tobytes())
    return nr_reads


def simulate_reads(
    hap1: bytes,
    hap2: bytes,
    coverage: float,
    read_length: int,
    rng: np.random.Generator,
    error_rate: float = 0.001,
    outfile: Optional[str] = None,
) -> List[bytes]:
    """Uniform error-prone reads from the two haplotypes (vectorized:
    window gather + bulk error/strand application, so genome-scale
    read sets simulate in seconds rather than minutes)."""
    total_bases = int(coverage * (len(hap1) + len(hap2)) / 2)
    nr_reads = max(1, total_bases // read_length)

    if len(hap1) <= read_length or len(hap2) <= read_length:
        # tiny-haplotype case (tests): per-read scalar path
        reads: List[bytes] = []
        for _ in range(nr_reads):
            hap = hap1 if rng.random() < 0.5 else hap2
            if len(hap) <= read_length:
                start = 0
            else:
                start = int(rng.integers(0, len(hap) - read_length))
            read = np.frombuffer(
                hap[start: start + read_length], np.uint8
            ).copy()
            errors = rng.random(len(read)) < error_rate
            if errors.any():
                read[errors] = _BASES[rng.integers(0, 4, int(errors.sum()))]
            if rng.random() < 0.5:
                reads.append(
                    bytes(read).translate(
                        bytes.maketrans(b"ACGT", b"TGCA")
                    )[::-1]
                )
            else:
                reads.append(bytes(read))
    else:
        haps = [np.frombuffer(h, np.uint8) for h in (hap1, hap2)]
        pick = rng.random(nr_reads) < 0.5
        window = np.arange(read_length)[None, :]
        arr = np.empty((nr_reads, read_length), np.uint8)
        for h, mask in ((0, pick), (1, ~pick)):
            n = int(mask.sum())
            if n == 0:
                continue
            hap = haps[h]
            starts = rng.integers(0, len(hap) - read_length, size=n)
            arr[mask] = hap[starts[:, None] + window]
        errors = rng.random(arr.shape) < error_rate
        n_err = int(errors.sum())
        if n_err:
            arr[errors] = _BASES[rng.integers(0, 4, n_err)]
        # reverse-complement a random half (vectorized translate+flip)
        comp_lut = np.zeros(256, np.uint8)
        comp_lut[np.frombuffer(b"ACGT", np.uint8)] = np.frombuffer(
            b"TGCA", np.uint8
        )
        flip = rng.random(nr_reads) < 0.5
        arr[flip] = comp_lut[arr[flip]][:, ::-1]
        reads = [row.tobytes() for row in arr]
    if outfile:
        with open(outfile, "w") as out:
            chunk: List[str] = []
            for i, read in enumerate(reads):
                chunk.append(f">read{i}\n")
                chunk.append(read.decode())
                chunk.append("\n")
                if len(chunk) >= 30000:
                    out.write("".join(chunk))
                    chunk = []
            out.write("".join(chunk))
    return reads


def truth_genotypes(
    variants: Sequence[SimVariant], sample: int
) -> Dict[int, Tuple[int, int]]:
    """position (0-based) -> unordered genotype of the sample."""
    return {
        v.position: tuple(sorted(v.genotypes[sample])) for v in variants
    }
