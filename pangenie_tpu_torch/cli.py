"""Command-line interface of the PyTorch/CUDA port.

    python -m pangenie_tpu_torch genotype -i reads.fa -r ref.fa -v vars.vcf -o out [...]

The ``genotype`` subcommand with ``-r``/``-v`` runs the fused single
command, with the reference package's flags and defaults
(``pangenie_tpu/cli.py``); the device comes from
``PANGENIE_TORCH_DEVICE`` (default ``cuda``, see ``device.py``). The
other entry points —
``index``, ``genotype -f``, ``vcf``, ``sampling``, ``analyze-uk`` and
phasing (``-p``) — are not ported yet and exit with an error that names
their ROADMAP.md item.
"""

from __future__ import annotations

import argparse
import sys

VERSION = "0.1.0"

_NOT_PORTED = {
    "index": "ROADMAP queue 1: index and genotype -f",
    "vcf": "ROADMAP queue 1: remaining commands (vcf, sampling, analyze-uk)",
    "sampling": "ROADMAP queue 1: remaining commands (vcf, sampling, analyze-uk)",
    "analyze-uk": "ROADMAP queue 1: remaining commands (vcf, sampling, analyze-uk)",
}


def _add_genotype_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("-i", dest="readfile", required=True,
                   help="sequencing reads in FASTA/FASTQ format (uncompressed)")
    p.add_argument("-f", dest="precomputed_prefix", default="",
                   help="filename prefix of files computed by the index "
                        "subcommand (not ported yet)")
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
                   help="run phasing (Viterbi; not ported yet)")
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
    p_gt = sub.add_parser("genotype", help="genotype a sample")
    _add_genotype_args(p_gt)
    for name in _NOT_PORTED:
        sub.add_parser(name, help="not ported yet", add_help=False)

    args, extra = parser.parse_known_args(argv)
    if args.command in _NOT_PORTED:
        raise NotImplementedError(
            f"'{args.command}' is not ported yet ({_NOT_PORTED[args.command]})"
        )
    if extra:
        parser.error(f"unrecognized arguments: {' '.join(extra)}")

    if args.precomputed_prefix:
        raise NotImplementedError(
            "genotype -f is not ported yet (ROADMAP queue 1: index and "
            "genotype -f)"
        )
    if not (args.reffile and args.vcffile):
        parser.error("genotype requires both -r and -v")
    # reference constraints (src/pangenie-genotype.cpp:71-74)
    if args.panel_size and args.sampling_size:
        parser.error("options -x and -a cannot be used together")
    if args.phasing_flag:
        raise NotImplementedError(
            "phasing (-p) is not ported yet (ROADMAP queue 1, hmm/viterbi.py)"
        )

    from . import commands

    return commands.run_single_command(
        args.readfile, args.reffile, args.vcffile, args.kmersize,
        args.outname,
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


if __name__ == "__main__":
    sys.exit(main())
