"""Command-line interface of the PyTorch/CUDA port.

    python -m pangenie_tpu_torch index    -r ref.fa -v vars.vcf -o prefix [-k 31] [-t N] [-e N]
    python -m pangenie_tpu_torch genotype -i reads.fa (-f prefix | -r ref.fa -v vars.vcf) -o out [...]
    python -m pangenie_tpu_torch vcf      -z results.pkl -f prefix -o out [...]
    python -m pangenie_tpu_torch sampling -i reads.fa -f prefix -o out -x size [...]
    python -m pangenie_tpu_torch analyze-uk -i prefix_UniqueKmersMap.pkl

Subcommands and flags follow the reference package
(``pangenie_tpu/cli.py``): ``index`` once per panel, then
``genotype -f`` once per sample, or ``genotype -r -v`` for both in one
run; ``genotype -w`` serializes the results and ``vcf`` turns them into
a VCF. ``sampling`` reduces an index's panel to ``-x`` haplotypes from
one sample's reads and writes the panel VCF and per-chromosome paths
TSVs; ``analyze-uk`` prints an index's unique k-mer matrices. An index
or result written by ``pangenie_tpu`` is not readable here (its pickles
hold that package's classes, and unpickling them imports JAX): index
the panel with this port. The device comes from
``PANGENIE_TORCH_DEVICE`` (default ``cuda``, see ``device.py``).
``-p`` phases (``<out>_phasing.vcf``): alone it phases only, with ``-g``
it genotypes too (the reference's wiring, src/pangenie-genotype.cpp:98-109).
"""

from __future__ import annotations

import argparse
import sys

VERSION = "0.1.0"


def _outputs(args) -> dict:
    """only_genotyping / only_phasing from -g and -p, as the reference
    wires them (src/pangenie-genotype.cpp:98-109): -p alone phases only,
    -g -p does both, anything else genotypes only."""
    both = args.genotyping_flag and args.phasing_flag
    phasing_only = args.phasing_flag and not args.genotyping_flag
    return dict(only_genotyping=not (both or phasing_only), only_phasing=phasing_only)


def _add_genotype_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("-i", dest="readfile", required=True,
                   help="sequencing reads in FASTA/FASTQ format (uncompressed)")
    p.add_argument("-f", dest="precomputed_prefix", default="",
                   help="filename prefix of files computed by this port's "
                        "index subcommand (an index of pangenie_tpu is not "
                        "readable here)")
    p.add_argument("-r", dest="reffile", default="",
                   help="reference genome in FASTA format (uncompressed)")
    p.add_argument("-v", dest="vcffile", default="",
                   help="variants in VCF format (uncompressed)")
    p.add_argument("-k", dest="kmersize", type=int, default=31, help="kmer size")
    p.add_argument("-o", dest="outname", default="result",
                   help="prefix of the output files")
    p.add_argument("-s", dest="sample_name", default="sample",
                   help="name of the sample (used in the output VCFs)")
    p.add_argument("-j", dest="nr_jellyfish_threads", type=int, default=1,
                   help="number of threads to use for kmer-counting")
    p.add_argument("-t", dest="nr_core_threads", type=int, default=1,
                   help="number of threads to use for the core algorithm")
    p.add_argument("-g", dest="genotyping_flag", action="store_true",
                   help="run genotyping (Forward-Backward, default)")
    p.add_argument("-p", dest="phasing_flag", action="store_true",
                   help="run phasing (Viterbi). Experimental feature")
    p.add_argument("-c", dest="count_all", action="store_true",
                   help="count all read kmers instead of only those in the graph")
    p.add_argument("-u", dest="ignore_imputed", action="store_true",
                   help="output ./. for variants not covered by any unique kmer")
    p.add_argument("-a", dest="sampling_size", type=int, default=0,
                   help="sample subsets of paths of this size")
    p.add_argument("-e", dest="hash_size", type=int, default=3000000000,
                   help="(compatibility) size of hash used by jellyfish")
    p.add_argument("-x", dest="panel_size", type=int, default=0,
                   help="to which size the input panel shall be reduced")
    p.add_argument("-d", dest="output_panel", action="store_true",
                   help="write sampled panel to an additional output VCF")
    p.add_argument("-y", dest="allele_penalty", type=int, default=5,
                   help="penalty for already selected alleles in sampling")
    p.add_argument("-b", dest="sampling_effective_N", type=float, default=0.01,
                   help="effective population size for the sampling step")
    p.add_argument("-w", dest="serialize_output", action="store_true",
                   help="serialize genotyping results instead of writing a VCF")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    parser = argparse.ArgumentParser(
        prog="pangenie-tpu-torch",
        description=(
            "PanGenie on PyTorch/CUDA — genotyping based on kmer-counting "
            "and known haplotype sequences."
        ),
    )
    parser.add_argument("--version", action="version", version=VERSION)
    sub = parser.add_subparsers(dest="command", required=True)

    p_index = sub.add_parser("index", help="preprocess reference + VCF")
    p_index.add_argument("-r", dest="reffile", required=True,
                         help="reference genome in FASTA format (uncompressed)")
    p_index.add_argument("-v", dest="vcffile", required=True,
                         help="variants in VCF format (uncompressed)")
    p_index.add_argument("-o", dest="outname", required=True,
                         help="prefix of the index files")
    p_index.add_argument("-k", dest="kmersize", type=int, default=31, help="kmer size")
    p_index.add_argument("-t", dest="nr_threads", type=int, default=1,
                         help="number of threads")
    p_index.add_argument("-e", dest="hash_size", type=int, default=3000000000,
                         help="(compatibility) size of hash used by jellyfish")

    p_gt = sub.add_parser("genotype", help="genotype a sample")
    _add_genotype_args(p_gt)

    # flag for flag with the reference (src/pangenie-vcf.cpp:31-38)
    p_vcf = sub.add_parser("vcf", help="convert serialized results to VCF")
    p_vcf.add_argument("-z", dest="results_name", required=True,
                       help="serialized genotyping results (produced by "
                            "genotype run with parameter -w)")
    p_vcf.add_argument("-f", dest="precomputed_prefix", required=True,
                       help="filename prefix of the index files")
    p_vcf.add_argument("-o", dest="outname", default="result")
    p_vcf.add_argument("-s", dest="sample_name", default="sample")
    p_vcf.add_argument("-g", dest="genotyping_flag", action="store_true")
    p_vcf.add_argument("-p", dest="phasing_flag", action="store_true",
                       help="phasing output")
    p_vcf.add_argument("-u", dest="ignore_imputed", action="store_true")

    # flag for flag with the reference package's
    p_uk = sub.add_parser("analyze-uk", help="print unique-kmer matrices")
    p_uk.add_argument("-i", dest="precomputed_uk", required=True,
                      help="serialized UniqueKmersMap (.pkl)")

    p_sm = sub.add_parser("sampling", help="subsample panel, emit panel VCF")
    p_sm.add_argument("-i", dest="readfile", required=True)
    p_sm.add_argument("-f", dest="precomputed_prefix", required=True)
    p_sm.add_argument("-o", dest="outname", required=True)
    p_sm.add_argument("-x", dest="panel_size", type=int, required=True)
    p_sm.add_argument("-j", dest="nr_jellyfish_threads", type=int, default=1)
    p_sm.add_argument("-t", dest="nr_core_threads", type=int, default=1)
    p_sm.add_argument("-c", dest="count_all", action="store_true")
    p_sm.add_argument("-y", dest="allele_penalty", type=int, default=5)
    p_sm.add_argument("-b", dest="sampling_effective_N", type=float, default=0.01)

    args = parser.parse_args(argv)

    from . import commands

    if args.command == "analyze-uk":
        return commands.run_analyze_uk(args.precomputed_uk)

    if args.command == "sampling":
        return commands.run_sampling(
            args.precomputed_prefix, args.readfile, args.outname,
            args.nr_jellyfish_threads, args.nr_core_threads,
            count_only_graph=not args.count_all,
            panel_size=args.panel_size,
            allele_penalty=args.allele_penalty,
            sampling_effective_N=args.sampling_effective_N,
        )

    if args.command == "index":
        return commands.run_index_command(
            args.reffile, args.vcffile, args.kmersize, args.outname,
            args.nr_threads, add_reference=True, hash_size=args.hash_size,
        )

    if args.command == "vcf":
        return commands.run_vcf_command(
            args.precomputed_prefix, args.results_name, args.outname,
            args.sample_name, ignore_imputed=args.ignore_imputed, **_outputs(args),
        )

    has_f = bool(args.precomputed_prefix)
    if has_f == bool(args.reffile and args.vcffile):
        parser.error("genotype requires either -f or both -r and -v")
    # reference constraints (src/pangenie-genotype.cpp:71-74)
    if args.panel_size and args.sampling_size:
        parser.error("options -x and -a cannot be used together")
    if has_f and args.kmersize != 31:
        parser.error("option -k cannot be combined with -f (the index fixes "
                     "the kmer size)")
    common = dict(
        **_outputs(args),
        sample_name=args.sample_name,
        nr_jellyfish_threads=args.nr_jellyfish_threads,
        nr_core_threads=args.nr_core_threads,
        count_only_graph=not args.count_all,
        ignore_imputed=args.ignore_imputed,
        sampling_size=args.sampling_size,
        panel_size=args.panel_size,
        output_panel=args.output_panel,
        sampling_effective_N=args.sampling_effective_N,
        allele_penalty=args.allele_penalty,
        serialize_output=args.serialize_output,
        hash_size=args.hash_size,
    )
    if has_f:
        return commands.run_genotype_command(
            args.precomputed_prefix, args.readfile, args.outname, **common
        )
    return commands.run_single_command(
        args.readfile, args.reffile, args.vcffile, args.kmersize,
        args.outname, **common
    )


if __name__ == "__main__":
    sys.exit(main())
