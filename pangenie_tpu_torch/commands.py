"""Pipeline commands: ``index``, ``genotype`` (from an index),
``single`` (index + genotype fused), ``vcf``, ``sampling`` (panel
reduction to a panel VCF) and ``analyze-uk``.

Port of ``pangenie_tpu/commands.py`` (reference src/commands.cpp): same
phase structure, same intermediate artifacts (path-segments FASTA,
per-chromosome k-mer TSVs, pickled graphs and unique-k-mer maps, pickled
results), same defaults, including auto-sampling above 100 paths. Host
phases (parsing, k-mer counting on the C++ engine, unique k-mer
selection, VCF writing) are the reference package's code; the device
stages — haplotype sampling (kernel S1), genotyping forward-backward
(kernels K1/K2, or K3/K4 for many-allele batches and long chromosomes)
and phasing, ``-p`` (the Viterbi, kernel V1) — run in torch on the
chosen device, and so does read k-mer counting on the card (kernels
D1-extract and D1-count, ``kmers/device_counter.py``).

Pickles hold the port's own classes: an index or result pickled by
``pangenie_tpu`` cannot be read here (unpickling it imports JAX).

Not ported yet: multi-process runs (with the sharded k-mer counter).
"""

from __future__ import annotations

import os
import pickle
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from .device import hmm_dtype, resolve_device
from .hmm.columns import densify_records
from .hmm.genotyping import NP_DTYPE, PairHMM
from .kmers.counter import ExactKmerCounter, KmerCounter
from .kmers.unique import (
    StepwiseUniqueKmerComputer,
    UniqueKmerComputer,
    UniqueKmersRecord,
)
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
    """Serialized index payload (reference src/commands.hpp:11-28)."""

    kmersize: int = 0
    add_reference: bool = False
    unique_kmers: Dict[str, List[UniqueKmersRecord]] = field(default_factory=dict)
    runtimes: Dict[str, float] = field(default_factory=dict)
    sampling_runtimes: Dict[str, float] = field(default_factory=dict)


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


def _device_counter(device: torch.device) -> bool:
    """Route read k-mer counting through D1 (``kmers/device_counter.py``):
    PANGENIE_TORCH_COUNTER=device forces it (on the CPU: D1's plain
    versions), =host forbids it; otherwise on the card, and never on the
    CPU, as the reference routes (``pangenie_tpu/commands.py:113``), but
    without its TPU read-volume threshold."""
    env = os.environ.get("PANGENIE_TORCH_COUNTER", "").lower()
    if env in ("device", "host"):
        return env == "device"
    if env:
        raise RuntimeError(f"PANGENIE_TORCH_COUNTER={env!r}: expected device or host")
    return device.type == "cuda"


def _read_counter(
    readfile: str,
    segment_file: str,
    kmersize: int,
    count_only_graph: bool,
    nr_threads: int = 1,
    hash_size: int = 3_000_000_000,
    prime_keys=None,
    device: torch.device = torch.device("cpu"),
) -> KmerCounter:
    """Read k-mer counts. Counting only graph k-mers (every command
    without -c) runs on D1 where :func:`_device_counter` routes it and
    the table fits the card (``device_counter.table_fits``, from D1's own
    footprint; without ``prime_keys`` the card builds the table, and the
    path-segments FASTA's size bounds its keys); else, and for -c, on the
    host engine (csrc/kmercount.cpp)."""
    if readfile.endswith(".jf"):
        from .kmers.jf_reader import read_jf

        _log("Read pre-computed read kmer counts ...")
        return read_jf(readfile, kmersize)
    _log("Count kmers in reads ...")
    if count_only_graph:
        if _device_counter(device):
            from .kmers import device_counter

            # the `-e` hash size bounds the streaming block (the table
            # itself is O(graph kmers)); /64 maps the reference's 3e9
            # entry default to ~48 Mb blocks
            block = int(min(max(hash_size // 64, 1 << 22), 1 << 28))
            n_keys = (len(prime_keys) if prime_keys is not None
                      else os.path.getsize(segment_file))
            if device_counter.table_fits(n_keys, device, block):
                _log(f"  using device PRIME+UPDATE counter (D1) on {device}")
                return device_counter.count_file_primed_device(
                    readfile, [segment_file], kmersize, block_bases=block,
                    keys=prime_keys, device=device,
                )
            _log("  graph table exceeds the card's memory; counting on the "
                 "host engine")
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
    only_genotyping: bool,
    only_phasing: bool,
    effective_N: float,
    recombrate: float,
    sampling_size: int,
    output_panel: bool,
    chrom_to_sampled: Dict[str, List[SampledPanel]],
    device: torch.device,
) -> None:
    """Genotyping and phasing section (reference src/commands.cpp:908-1009)."""
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
    if not only_phasing:
        _log(
            f"Sampled {len(subsets)} subset(s) of paths each of size "
            f"{sampling_size} for genotyping."
        )

    phasing_paths: List[int] = []
    path_sampler.select_single_subset(phasing_paths, min(nr_paths, 30))
    if not only_genotyping:
        _log(f"Sampled {len(phasing_paths)} paths to be used for phasing.")

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
    # (combine into the phasing run's empty likelihood maps is the
    # identity, so pre-normalized values survive it)
    normalize_in_run = len(subsets) == 1
    # per chromosome the phasing run first, then the genotyping subsets:
    # the first run's results are the stored list (its haplotypes), the
    # others' likelihoods are combined into it
    run_specs: List[tuple] = []  # (chromosome, genotyping?, paths)
    for chromosome in chromosomes:
        if not only_genotyping:
            run_specs.append((chromosome, False, phasing_paths))
        if not only_phasing:
            run_specs.extend((chromosome, True, subset) for subset in subsets)
    all_runs: List[tuple] = []
    cols_cache: Dict[tuple, tuple] = {}  # (chromosome, paths) -> built columns
    for chromosome, is_genotyping, paths in run_specs:
        records = unique_kmers_list.unique_kmers[chromosome]
        cols_key = (chromosome, tuple(paths))
        hmm = PairHMM(
            records, probabilities, is_genotyping, not is_genotyping,
            recombrate, False, effective_N, paths,
            normalize=is_genotyping and normalize_in_run,
            dtype=dtype, defer=True, dense=dense_cache[chromosome],
            prebuilt=cols_cache.get(cols_key), bulk=True, device=device,
        )
        # genotyping and phasing over the same subset share columns
        cols_cache.setdefault(cols_key, hmm.shared_columns())
        all_runs.append((chromosome, hmm))
    del dense_cache, cols_cache
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

    if not only_phasing and not normalize_in_run:
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
    precomputed_prefix: str,
    outname: str,
    sample_name: str,
    only_genotyping: bool,
    only_phasing: bool,
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
        graph: ChromosomeGraph = _load(
            f"{precomputed_prefix}_{chromosome}_Graph.pkl"
        )
        _write_chromosome(graph, results, chromosome, outname, write_header,
                          sample_name, only_genotyping, only_phasing,
                          ignore_imputed)
        if output_panel:
            graph.write_sampled_panel(
                outname + "_panel.vcf", chrom_to_sampled[chromosome],
                write_header,
            )
        write_header = False


def _write_chromosome(graph: ChromosomeGraph, results: Results, chromosome: str,
                      outname: str, write_header: bool, sample_name: str,
                      only_genotyping: bool, only_phasing: bool,
                      ignore_imputed: bool) -> None:
    """One chromosome's lines of ``<out>_genotyping.vcf`` (unless
    phasing only) and ``<out>_phasing.vcf`` (unless genotyping only)."""
    bulk = results.bulk.get(chromosome)
    if not only_phasing:
        graph.write_genotypes(
            outname + "_genotyping.vcf", results.result[chromosome],
            write_header, sample_name, ignore_imputed, bulk,
        )
    if not only_genotyping:
        graph.write_phasing(
            outname + "_phasing.vcf", results.result[chromosome],
            write_header, sample_name, ignore_imputed, bulk,
        )


def _use_device(device: Optional[str]) -> torch.device:
    """The run's torch device (see :mod:`device`); a CUDA device becomes
    the current one, where the kernels launch."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    return dev


def run_index_command(
    reffile: str,
    vcffile: str,
    kmersize: int,
    outname: str,
    nr_jellyfish_threads: int = 1,
    add_reference: bool = True,
    hash_size: int = 3_000_000_000,
) -> int:
    """PanGenie-index (reference src/commands.cpp:592-728). Host only.

    ``hash_size`` is the CLI's -e (the reference's jellyfish hash
    size); here it bounds the graph k-mer counter's streaming block."""
    check_input_file(reffile)
    check_input_file(vcffile)

    summary = PhaseSummary("PanGenie-index")
    segment_file = outname + "_path_segments.fasta"
    unique_kmers_list = UniqueKmersMap(kmersize=kmersize, add_reference=add_reference)

    _log("Determine allele sequences ...")
    panel = PanelBuilder(vcffile, reffile, segment_file, kmersize, add_reference)
    chromosomes = panel.get_chromosomes()
    _log(f"Found {len(chromosomes)} chromosome(s) in the VCF.")
    summary.phase("reading input files")

    _log("Count kmers in graph ...")
    genomic_kmer_counts = ExactKmerCounter.count_file(
        segment_file, kmersize, n_threads=nr_jellyfish_threads,
        block_bases=int(min(max(hash_size // 64, 1 << 22), 1 << 28)),
    )
    summary.phase("counting kmers in graph")

    import threading

    idx_thread = None
    if hasattr(genomic_kmer_counts, "prepare_lookup_index"):
        # build the selection phase's lookup index while graphs pickle
        idx_thread = threading.Thread(
            target=genomic_kmer_counts.prepare_lookup_index, daemon=True
        )
        idx_thread.start()

    _log("Serialize Graph objects ...")
    for chromosome in chromosomes:
        _save(panel.graphs[chromosome], f"{outname}_{chromosome}_Graph.pkl")
    summary.phase("writing Graph objects to disk")

    _log("Determine unique kmers ...")
    if idx_thread is not None:
        idx_thread.join()

    def _index_chromosome(chromosome):
        t = time.monotonic()
        computer = StepwiseUniqueKmerComputer(
            genomic_kmer_counts, panel.graphs[chromosome]
        )
        records = computer.compute_unique_kmers(
            f"{outname}_{chromosome}_kmers.tsv.gz", delete_processed_variants=True
        )
        return chromosome, records, time.monotonic() - t

    # one task per chromosome (src/commands.cpp:677-687); the native
    # k-mer lookups and numpy enumeration release the GIL
    from concurrent.futures import ThreadPoolExecutor

    workers = max(1, min(nr_jellyfish_threads, len(chromosomes)))
    with ThreadPoolExecutor(max_workers=workers) as pool:
        for chromosome, records, elapsed in pool.map(_index_chromosome, chromosomes):
            unique_kmers_list.unique_kmers[chromosome] = records
            unique_kmers_list.runtimes[chromosome] = elapsed
    summary.phase("determining unique kmers")

    _log("Storing unique kmer information ...")
    _save(unique_kmers_list, outname + "_UniqueKmersMap.pkl")
    summary.phase("writing UniqueKmersMap to disk")
    summary.print_summary()
    return 0


def fill_read_kmercounts(
    chromosome: str,
    unique_kmers_map: UniqueKmersMap,
    read_kmer_counts: KmerCounter,
    probabilities: ProbabilityTable,
    precomputed_prefix: str,
    kmer_coverage: int,
) -> None:
    """Stream the index's k-mer TSV and fill read counts and local
    coverage into the chromosome's records (reference
    src/commands.cpp:76-152).

    K-mer strings are encoded and looked up in bulk (one batched
    abundance query per chromosome); counts and coverage scatter back
    per record. The reference package ends with a per-chromosome
    ``HaplotypeSampler(..., size=0)`` call, which returns at once and
    whose time it records in ``sampling_runtimes``; here the call is
    dropped and its time recorded as 0. Panel sampling runs batched over
    all chromosomes afterwards.
    """
    import gzip

    from .kmers.mer import decode_kmer, encode_kmer_fields

    filename = f"{precomputed_prefix}_{chromosome}_kmers.tsv.gz"
    records = unique_kmers_map.unique_kmers[chromosome]
    kmersize = unique_kmers_map.kmersize
    min_cov = kmer_coverage // 4
    max_cov = kmer_coverage * 4

    # pass 1: parse the TSV; the k-mer columns stay comma-joined fields
    # (their length gives the count)
    kmer_fields: List[str] = []
    flank_fields: List[str] = []
    n_kmers: List[int] = []
    n_flanks: List[int] = []
    var_index = 0
    field_w = kmersize + 1
    with gzip.open(filename, "rt") as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            tokens = line.split("\t")
            assert len(tokens) == 5
            if tokens[0].startswith("#"):
                continue
            assert tokens[0] == chromosome
            assert int(tokens[1]) == records[var_index].get_variant_position()
            t3, t4 = tokens[3], tokens[4]
            if t3 != "nan":
                kmer_fields.append(t3)
                n_kmers.append((len(t3) + 1) // field_w)
            else:
                n_kmers.append(0)
            if t4 != "nan":
                flank_fields.append(t4)
                n_flanks.append((len(t4) + 1) // field_w)
            else:
                n_flanks.append(0)
            var_index += 1

    # pass 2: batched encode + abundance lookups
    encoded_kmers = encode_kmer_fields(kmer_fields, kmersize)
    counts = read_kmer_counts.get_abundances(encoded_kmers)
    flank_counts = read_kmer_counts.get_abundances(
        encode_kmer_fields(flank_fields, kmersize)
    )

    # zero-probability warnings (rare; reference src/commands.cpp:118-126)
    probs = probabilities.get_probabilities(kmer_coverage, counts)
    bad = np.nonzero(~(probs > 0).any(axis=1))[0]
    if len(bad):
        rec_of_kmer = np.repeat(np.arange(len(records)), np.asarray(n_kmers, np.int64))
        for b in bad.tolist():
            r = records[int(rec_of_kmer[b])]
            _log(
                "Warning: only zero probabilities for "
                f"{decode_kmer(int(encoded_kmers[b]), kmersize)} at "
                f"{chromosome} {r.get_variant_position()}"
            )

    # pass 3: local coverage per record = int mean of the flanking counts
    # within [peak/4, 4*peak], else the peak (src/kmerparser.cpp:30-49)
    sizes_f = np.asarray(n_flanks, dtype=np.int64)
    valid = (flank_counts >= min_cov) & (flank_counts <= max_cov)
    csum_v = np.concatenate([[0], np.cumsum(np.where(valid, flank_counts, 0))])
    csum_n = np.concatenate([[0], np.cumsum(valid.astype(np.int64))])
    ends = np.cumsum(sizes_f)
    starts = ends - sizes_f
    seg_sum = csum_v[ends] - csum_v[starts]
    seg_n = csum_n[ends] - csum_n[starts]
    coverages = np.where(
        (seg_n > 0) & (seg_sum > 0),
        seg_sum // np.maximum(seg_n, 1),
        kmer_coverage,
    ).tolist()

    offset = 0
    for i, record in enumerate(records):
        nk = n_kmers[i]
        if nk == record.size():
            record.set_readcounts(counts[offset: offset + nk])
        else:
            # TSV line and record disagree; per-kmer update keeps the
            # reference's bounds behaviour
            for j in range(nk):
                record.update_readcount(j, int(counts[offset + j]))
        offset += nk
        record.set_coverage(coverages[i])
    unique_kmers_map.sampling_runtimes[chromosome] = 0.0


def run_genotype_command(
    precomputed_prefix: str,
    readfile: str,
    outname: str,
    sample_name: str = "sample",
    nr_jellyfish_threads: int = 1,
    nr_core_threads: int = 1,
    only_genotyping: bool = True,
    only_phasing: bool = False,
    effective_N: float = 0.00001,
    regularization: float = 0.01,
    count_only_graph: bool = True,
    ignore_imputed: bool = False,
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
    """PanGenie genotype from an index written by :func:`run_index_command`
    (reference src/commands.cpp:730-1086). ``device`` as in
    :func:`run_single_command`; ``hash_size`` (-e) bounds the read
    k-mer counter's streaming block on the card."""
    check_input_file(readfile)
    segment_file = precomputed_prefix + "_path_segments.fasta"
    check_input_file(segment_file)
    archive = precomputed_prefix + "_UniqueKmersMap.pkl"
    check_input_file(archive)

    dev = _use_device(device)
    summary = PhaseSummary("PanGenie-genotype")
    results = Results()
    chrom_to_sampled: Dict[str, List[SampledPanel]] = {}

    _log(f"Reading precomputed UniqueKmersMap from {archive} ...")
    unique_kmers_list: UniqueKmersMap = _load(archive)

    # std::map iteration order: chromosome names sorted
    chromosomes = sorted(unique_kmers_list.unique_kmers.keys())
    nr_paths = 0
    variants_read = 0
    for chromosome in chromosomes:
        records = unique_kmers_list.unique_kmers[chromosome]
        if records:
            nr_paths = records[0].get_nr_paths()
            variants_read += len(records)
    _log(f"Read {variants_read} variants from provided UniqueKmersMap archive.")
    if variants_read == 0:
        return 0
    if nr_paths == 0:
        raise RuntimeError("PanGenie-index: no haplotype paths given.")

    if panel_size == 0 and sampling_size == 0 and nr_paths > 100:
        panel_size = 15
        _log(
            "Number of haplotypes exceeds 100, enable haplotype sampling "
            "(15 haplotypes)"
        )
    summary.phase("reading UniqueKmersMap from disk")

    kmersize = unique_kmers_list.kmersize
    read_kmer_counts = _read_counter(
        readfile, segment_file, kmersize, count_only_graph, nr_jellyfish_threads,
        hash_size, device=dev,
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

    _log("Determine read k-mer counts for unique kmers ...")
    from concurrent.futures import ThreadPoolExecutor

    def _fill(chromosome):
        fill_read_kmercounts(
            chromosome, unique_kmers_list, read_kmer_counts, probabilities,
            precomputed_prefix, kmer_abundance_peak,
        )

    workers = max(1, min(nr_core_threads, len(chromosomes)))
    with ThreadPoolExecutor(max_workers=workers) as pool:
        list(pool.map(_fill, chromosomes))
    # haplotype sampling: all chromosomes batched into shared device sweeps
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
            panel_size, recombrate, sampling_effective_N,
            unique_kmers_list.add_reference, path_outputs, allele_penalty,
            device=dev,
        )
    summary.phase("updating unique kmers / sampling")

    _genotyping_block(
        chromosomes, unique_kmers_list, probabilities, results,
        only_genotyping, only_phasing, effective_N, recombrate,
        sampling_size, output_panel, chrom_to_sampled, dev,
    )
    summary.phase("genotyping (HMM)")

    _write_outputs(
        chromosomes, results, precomputed_prefix, outname, sample_name,
        only_genotyping, only_phasing, ignore_imputed, output_panel,
        chrom_to_sampled, serialize_output,
    )
    summary.phase("writing output")
    summary.print_summary()
    return 0


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
    check_input_file(reffile)
    check_input_file(vcffile)
    check_input_file(readfile)

    dev = _use_device(device)
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
        nr_jellyfish_threads, hash_size,
        prime_keys=(
            genomic_kmer_counts.keys if count_only_graph else None
        ),
        device=dev,
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
        only_genotyping, only_phasing, effective_N, recombrate,
        sampling_size, output_panel, chrom_to_sampled, dev,
    )
    summary.phase("genotyping (HMM)")

    _write_outputs(
        chromosomes, results, outname, outname, sample_name, only_genotyping,
        only_phasing, ignore_imputed, output_panel, chrom_to_sampled,
        serialize_output,
    )
    summary.phase("writing output")
    summary.print_summary()
    return 0


def run_vcf_command(
    precomputed_prefix: str,
    results_name: str,
    outname: str,
    sample_name: str = "sample",
    only_genotyping: bool = True,
    only_phasing: bool = False,
    ignore_imputed: bool = False,
) -> int:
    """PanGenie-vcf: results serialized by ``genotype -w`` -> VCF
    (reference src/commands.cpp:1088-1154)."""
    check_input_file(results_name)
    _log(f"Reading serialized genotyping results from {results_name}")
    results: Results = _load(results_name)

    _log("Write results to VCF ...")
    write_header = True
    for chromosome in sorted(results.result.keys()):
        graph: ChromosomeGraph = _load(
            f"{precomputed_prefix}_{chromosome}_Graph.pkl"
        )
        _write_chromosome(graph, results, chromosome, outname, write_header,
                          sample_name, only_genotyping, only_phasing,
                          ignore_imputed)
        write_header = False
    return 0


def run_sampling(
    precomputed_prefix: str,
    readfile: str,
    outname: str,
    nr_jellyfish_threads: int = 1,
    nr_core_threads: int = 1,
    regularization: float = 0.01,
    count_only_graph: bool = True,
    panel_size: int = 0,
    recombrate: float = 1.26,
    sampling_effective_N: float = 0.01,
    allele_penalty: int = 5,
    hash_size: int = 3_000_000_000,
    device: Optional[str] = None,
) -> int:
    """PanGenie-sampling (reference src/commands.cpp:1156-1360): reduce
    an index's panel to ``panel_size`` haplotypes from one sample's reads
    and write them as ``<outname>_panel.vcf``, with the per-column
    ``<outname>_paths_<chromosome>.tsv`` files. ``device`` as in
    :func:`run_single_command`; ``hash_size`` (-e) bounds the read
    k-mer counter's streaming block on the card."""
    check_input_file(readfile)
    segment_file = precomputed_prefix + "_path_segments.fasta"
    check_input_file(segment_file)
    archive = precomputed_prefix + "_UniqueKmersMap.pkl"
    check_input_file(archive)

    dev = _use_device(device)
    summary = PhaseSummary("PanGenie-sampling")
    unique_kmers_list: UniqueKmersMap = _load(archive)
    chromosomes = sorted(unique_kmers_list.unique_kmers.keys())
    if not sum(len(unique_kmers_list.unique_kmers[c]) for c in chromosomes):
        return 0
    summary.phase("reading UniqueKmersMap from disk")

    read_kmer_counts = _read_counter(
        readfile, segment_file, unique_kmers_list.kmersize, count_only_graph,
        nr_jellyfish_threads, hash_size, device=dev,
    )
    kmer_abundance_peak = read_kmer_counts.compute_histogram(
        10000, count_only_graph, outname + "_histogram.histo"
    )
    probabilities = ProbabilityTable(
        kmer_abundance_peak // 4,
        kmer_abundance_peak * 4,
        2 * kmer_abundance_peak,
        regularization,
    )
    summary.phase("counting kmers in reads")

    from concurrent.futures import ThreadPoolExecutor

    from .hmm.sampling import sample_panels_batched

    def _fill(chromosome):
        fill_read_kmercounts(
            chromosome, unique_kmers_list, read_kmer_counts, probabilities,
            precomputed_prefix, kmer_abundance_peak,
        )

    workers = max(1, min(nr_core_threads, len(chromosomes)))
    with ThreadPoolExecutor(max_workers=workers) as pool:
        list(pool.map(_fill, chromosomes))
    summary.phase("updating unique kmers")
    # sampling always writes the paths TSVs (src/commands.cpp:1285)
    sample_panels_batched(
        {c: unique_kmers_list.unique_kmers[c] for c in chromosomes},
        panel_size, recombrate, sampling_effective_N,
        unique_kmers_list.add_reference,
        {c: f"{outname}_paths_{c}.tsv" for c in chromosomes},
        allele_penalty, device=dev,
    )
    summary.phase("sampling haplotypes")

    _log("Write sampled panel to VCF ...")
    write_header = True
    for chromosome in chromosomes:
        sampled = [
            SampledPanel(record.get_path_ids()[1], record.size())
            for record in unique_kmers_list.unique_kmers[chromosome]
        ]
        graph: ChromosomeGraph = _load(f"{precomputed_prefix}_{chromosome}_Graph.pkl")
        graph.write_sampled_panel(outname + "_panel.vcf", sampled, write_header)
        write_header = False
    summary.phase("writing output")
    summary.print_summary()
    return 0


def run_analyze_uk(precomputed_uk: str) -> int:
    """Print the kmer x allele incidence matrix of every variant of a
    serialized UniqueKmersMap (reference src/analyze-uk.cpp: one line per
    allele, chromosome / position / 0-1 kmer bitstring). Host only."""
    check_input_file(precomputed_uk)
    unique_kmers_list: UniqueKmersMap = _load(precomputed_uk)
    try:
        for chromosome in sorted(unique_kmers_list.unique_kmers.keys()):
            for record in unique_kmers_list.unique_kmers[chromosome]:
                for allele in record.get_allele_ids():
                    bits = "".join(
                        "1" if record.kmer_on_allele(ki, allele) else "0"
                        for ki in range(record.size())
                    )
                    print(f"{chromosome}\t{record.get_variant_position()}\t{bits}")
    except BrokenPipeError:
        # downstream pipe (e.g. `| head`) closed: standard unix-tool exit
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
    return 0
