"""Pipeline driver: the fused ``single`` command (index + genotype).

Port of ``pangenie_tpu/commands.py:run_single_command`` and its
helpers (reference src/commands.cpp:224-590): same phase structure,
same intermediate artifacts (path-segments FASTA, pickled graphs),
same defaults, including auto-sampling above 100 paths. Host phases
(parsing, k-mer counting on the C++ engine, unique k-mer selection,
VCF writing) are the reference package's code; the two device stages
— haplotype sampling (kernel S1) and genotyping forward-backward
(kernels K1/K2) — run in torch on the chosen device.

Not ported yet: phasing (``-p``); the ``index``, ``genotype -f``,
``vcf``, ``sampling`` and ``analyze-uk`` commands; the device k-mer
counter; multi-process runs.
"""

from __future__ import annotations

import os
import pickle
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from .device import hmm_dtype, resolve_device
from .hmm.columns import densify_records
from .hmm.genotyping import NP_DTYPE, PairHMM
from .kmers.counter import ExactKmerCounter, KmerCounter
from .kmers.unique import UniqueKmerComputer, UniqueKmersRecord
from .model.probabilities import ProbabilityTable
from .panel.builder import PanelBuilder
from .panel.graph import ChromosomeGraph
from .panel.sampling import PathSampler
from .panel.variant import GenotypeLikelihoods, SampledPanel
from .utils.timer import PhaseSummary


def check_input_file(filename: str) -> None:
    """Reject gzipped inputs, as the reference does
    (src/commands.cpp:42-56)."""
    if filename.endswith(".gz"):
        raise RuntimeError(
            f"File: {filename} is gzipped. PanGenie requires an uncompressed file."
        )
    if not os.path.exists(filename):
        raise RuntimeError(f"File: {filename} does not exist.")


@dataclass
class UniqueKmersMap:
    """Unique k-mers per chromosome (reference src/commands.hpp:11-28)."""

    kmersize: int = 0
    add_reference: bool = False
    unique_kmers: Dict[str, List[UniqueKmersRecord]] = field(default_factory=dict)


@dataclass
class Results:
    """Genotyping results per chromosome (src/commands.cpp:59-73)."""

    result: Dict[str, List[GenotypeLikelihoods]] = field(default_factory=dict)
    runtimes: Dict[str, float] = field(default_factory=dict)
    # chromosome -> (mask[M], vals[M, 3]): array-resident likelihoods
    # for canonical biallelic variants (single-subset normalized runs);
    # rows masked here hold empty dicts in `result` and the VCF writers
    # read the arrays directly
    bulk: Dict[str, tuple] = field(default_factory=dict)


def _log(msg: str) -> None:
    print(msg, file=sys.stderr)


def _save(obj, filename: str) -> None:
    with open(filename, "wb") as f:
        pickle.dump(obj, f, protocol=pickle.HIGHEST_PROTOCOL)


def _load(filename: str):
    with open(filename, "rb") as f:
        return pickle.load(f)


def _read_counter(
    readfile: str,
    segment_file: str,
    kmersize: int,
    count_only_graph: bool,
    nr_threads: int = 1,
    prime_keys=None,
) -> KmerCounter:
    """Read k-mer counts on the host engine (csrc/kmercount.cpp)."""
    if readfile.endswith(".jf"):
        from .kmers.jf_reader import read_jf

        _log("Read pre-computed read kmer counts ...")
        return read_jf(readfile, kmersize)
    _log("Count kmers in reads ...")
    if count_only_graph:
        return ExactKmerCounter.count_file_primed(
            readfile, [segment_file], kmersize, n_threads=nr_threads,
            keys=prime_keys,
        )
    return ExactKmerCounter.count_file(readfile, kmersize)


def _genotyping_block(
    chromosomes: List[str],
    unique_kmers_list: UniqueKmersMap,
    probabilities: ProbabilityTable,
    results: Results,
    effective_N: float,
    recombrate: float,
    sampling_size: int,
    output_panel: bool,
    chrom_to_sampled: Dict[str, List[SampledPanel]],
    device: torch.device,
) -> None:
    """Genotyping section (reference src/commands.cpp:908-1009)."""
    nr_paths = 0
    for chromosome in chromosomes:
        records = unique_kmers_list.unique_kmers[chromosome]
        if records:
            nr_paths = records[0].get_nr_paths()
            break

    if sampling_size == 0 or sampling_size > nr_paths:
        sampling_size = nr_paths

    path_sampler = PathSampler(nr_paths)
    subsets: List[List[int]] = []
    path_sampler.partition_samples(subsets, sampling_size)
    _log(
        f"Sampled {len(subsets)} subset(s) of paths each of size "
        f"{sampling_size} for genotyping."
    )

    _log("Construct HMM and run core algorithm ...")
    t = time.monotonic()
    dtype = hmm_dtype(device)
    np_dtype = NP_DTYPE[dtype]

    def _densify(chromosome):
        records = unique_kmers_list.unique_kmers[chromosome]
        return chromosome, (
            densify_records(records, probabilities, np_dtype)
            if records
            else None
        )

    # chromosome-level densification shared by every subset run; built
    # in parallel (bulk numpy releases the GIL)
    if len(chromosomes) > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=min(4, len(chromosomes))) as p:
            dense_cache = dict(p.map(_densify, chromosomes))
    else:
        dense_cache = dict(map(_densify, chromosomes))
    # with a single subset no cross-subset combine follows, so
    # normalization happens vectorized inside the posterior scatter
    normalize_in_run = len(subsets) == 1
    all_runs: List[tuple] = []
    for chromosome in chromosomes:
        records = unique_kmers_list.unique_kmers[chromosome]
        for paths in subsets:
            hmm = PairHMM(
                records, probabilities, True, False, recombrate, False,
                effective_N, paths, normalize=normalize_in_run,
                dtype=dtype, defer=True, dense=dense_cache[chromosome],
                bulk=True, device=device,
            )
            all_runs.append((chromosome, hmm))
    del dense_cache
    # the (chromosome x subset) grid executes as batched device sweeps
    PairHMM.run_deferred([hmm for _, hmm in all_runs])
    if all_runs:
        from .hmm import batch as hmm_batch

        # surface which implementation the forward-backward actually
        # used — a lost fast path must be visible in run logs
        _log(f"  forward-backward dispatch: {hmm_batch.last_dispatch}")
    for chromosome, hmm in all_runs:
        if chromosome not in results.result:
            results.result[chromosome] = hmm.move_genotyping_result()
        else:
            stored = results.result[chromosome]
            for i, likelihoods in enumerate(hmm.move_genotyping_result()):
                if likelihoods.likelihoods:
                    stored[i].combine(likelihoods)
        bulk = hmm.move_bulk_likelihoods()
        if bulk is not None:
            results.bulk[chromosome] = bulk
    for chromosome, hmm in all_runs:
        results.runtimes[chromosome] = (
            results.runtimes.get(chromosome, 0.0) + hmm.runtime
        )
    results.runtimes["all"] = time.monotonic() - t

    if not normalize_in_run:
        for chromosome in chromosomes:
            for g in results.result.get(chromosome, ()):
                g.normalize()

    if output_panel:
        for chromosome in chromosomes:
            for record in unique_kmers_list.unique_kmers[chromosome]:
                _, allele_ids = record.get_path_ids()
                chrom_to_sampled.setdefault(chromosome, []).append(
                    SampledPanel(allele_ids, record.size())
                )


def _write_outputs(
    chromosomes: List[str],
    results: Results,
    outname: str,
    sample_name: str,
    ignore_imputed: bool,
    output_panel: bool,
    chrom_to_sampled: Dict[str, List[SampledPanel]],
    serialize_output: bool,
) -> None:
    if serialize_output:
        _log("Serialize results ... ")
        _save(results, outname + "_genotyping.pkl")
        return
    _log("Write results to VCF ...")
    write_header = True
    for chromosome in chromosomes:
        graph: ChromosomeGraph = _load(f"{outname}_{chromosome}_Graph.pkl")
        graph.write_genotypes(
            outname + "_genotyping.vcf", results.result[chromosome],
            write_header, sample_name, ignore_imputed,
            results.bulk.get(chromosome),
        )
        if output_panel:
            graph.write_sampled_panel(
                outname + "_panel.vcf", chrom_to_sampled[chromosome],
                write_header,
            )
        write_header = False


def run_single_command(
    readfile: str,
    reffile: str,
    vcffile: str,
    kmersize: int = 31,
    outname: str = "result",
    sample_name: str = "sample",
    nr_jellyfish_threads: int = 1,
    nr_core_threads: int = 1,
    only_genotyping: bool = True,
    only_phasing: bool = False,
    effective_N: float = 0.00001,
    regularization: float = 0.01,
    count_only_graph: bool = True,
    ignore_imputed: bool = False,
    add_reference: bool = True,
    sampling_size: int = 0,
    panel_size: int = 0,
    recombrate: float = 1.26,
    output_panel: bool = False,
    sampling_effective_N: float = 0.01,
    allele_penalty: int = 5,
    serialize_output: bool = False,
    hash_size: int = 3_000_000_000,
    device: Optional[str] = None,
) -> int:
    """PanGenie single command (reference src/commands.cpp:224-590).

    ``device`` is a torch device name ("cuda", "cuda:1", "cpu"); None
    takes PANGENIE_TORCH_DEVICE, else "cuda" (see :mod:`device`).
    """
    if only_phasing or not only_genotyping:
        raise NotImplementedError(
            "phasing (-p) is not ported yet (ROADMAP queue 1, hmm/viterbi.py)"
        )
    check_input_file(reffile)
    check_input_file(vcffile)
    check_input_file(readfile)

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)   # the kernels launch on the current device
    summary = PhaseSummary("PanGenie")
    results = Results()
    chrom_to_sampled: Dict[str, List[SampledPanel]] = {}
    segment_file = outname + "_path_segments.fasta"
    unique_kmers_list = UniqueKmersMap(kmersize=kmersize, add_reference=add_reference)

    _log("Determine allele sequences ...")
    builder = PanelBuilder(vcffile, reffile, segment_file, kmersize, add_reference)
    nr_paths = builder.nr_of_paths()
    if panel_size == 0 and sampling_size == 0 and nr_paths > 100:
        panel_size = 15
        _log(
            "Number of haplotypes exceeds 100, enable haplotype sampling "
            "(15 haplotypes)"
        )
    chromosomes = builder.get_chromosomes()
    _log(f"Found {len(chromosomes)} chromosome(s) in the VCF.")
    summary.phase("reading input files")

    _log("Count kmers in graph ...")
    genomic_kmer_counts = ExactKmerCounter.count_file(
        segment_file, kmersize, n_threads=nr_jellyfish_threads,
        block_bases=int(min(max(hash_size // 64, 1 << 22), 1 << 28)),
    )
    summary.phase("counting kmers in graph")

    read_kmer_counts = _read_counter(
        readfile, segment_file, kmersize, count_only_graph,
        nr_jellyfish_threads,
        prime_keys=(
            genomic_kmer_counts.keys if count_only_graph else None
        ),
    )
    summary.phase("counting kmers in reads")

    kmer_abundance_peak = read_kmer_counts.compute_histogram(
        10000, count_only_graph, outname + "_histogram.histo"
    )
    _log(f"Computed kmer abundance peak: {kmer_abundance_peak}")

    probabilities = ProbabilityTable(
        kmer_abundance_peak // 4,
        kmer_abundance_peak * 4,
        2 * kmer_abundance_peak,
        regularization,
    )

    # the selection phase's open-addressing lookup indexes build in the
    # background, overlapped with the Graph pickling below (get_abundances
    # takes a lock, so a slow build simply blocks the first lookup)
    import threading

    idx_threads = [
        threading.Thread(target=c.prepare_lookup_index, daemon=True)
        for c in (genomic_kmer_counts, read_kmer_counts)
        if hasattr(c, "prepare_lookup_index")
    ]
    for t in idx_threads:
        t.start()

    # serialize graphs so they can be re-loaded for output writing after
    # streaming deletion (reference src/commands.cpp:343-347)
    _log("Serialize Graph objects ...")
    for chromosome in chromosomes:
        _save(builder.graphs[chromosome], f"{outname}_{chromosome}_Graph.pkl")
    summary.phase("writing Graph objects to disk")

    _log("Determine unique kmers ...")

    def _select_chromosome(chromosome: str):
        graph = builder.graphs[chromosome]
        computer = UniqueKmerComputer(
            genomic_kmer_counts, read_kmer_counts, graph, kmer_abundance_peak
        )
        return chromosome, computer.compute_unique_kmers(
            probabilities, delete_processed_variants=True
        )

    for t in idx_threads:
        t.join()
    # one selection task per chromosome over the -t worker pool
    # (reference src/commands.cpp:366-379); numpy sorts and the native
    # lookups release the GIL
    if nr_core_threads > 1 and len(chromosomes) > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=nr_core_threads) as pool:
            for chromosome, records in pool.map(
                _select_chromosome, chromosomes
            ):
                unique_kmers_list.unique_kmers[chromosome] = records
    else:
        for chromosome in chromosomes:
            chromosome, records = _select_chromosome(chromosome)
            unique_kmers_list.unique_kmers[chromosome] = records
    summary.phase("determining unique kmers")

    if panel_size > 0 or output_panel:
        from .hmm.sampling import sample_panels_batched

        path_outputs = {}
        if output_panel:
            path_outputs = {
                chromosome: f"{outname}_paths_{chromosome}.tsv"
                for chromosome in chromosomes
            }
        sample_panels_batched(
            {c: unique_kmers_list.unique_kmers[c] for c in chromosomes},
            panel_size, recombrate, sampling_effective_N, add_reference,
            path_outputs, allele_penalty, device=dev,
        )
    summary.phase("sampling haplotypes")

    _genotyping_block(
        chromosomes, unique_kmers_list, probabilities, results,
        effective_N, recombrate, sampling_size, output_panel,
        chrom_to_sampled, dev,
    )
    summary.phase("genotyping (HMM)")

    _write_outputs(
        chromosomes, results, outname, sample_name, ignore_imputed,
        output_panel, chrom_to_sampled, serialize_output,
    )
    summary.phase("writing output")
    summary.print_summary()
    return 0
