"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as it runs; any failure exits non-zero:

1. environment: torch/CUDA versions, GPU name and power limit, nvcc;
2. build: the CUDA kernels (K1-K4 in csrc/fb.cu, S1's sweep and chase
   in csrc/sampling_dp.cu, V1 in csrc/viterbi.cu, D1-extract, D1-count
   and D1-count-keys in csrc/kmer_count.cu) and the host k-mer engine, from this
   checkout, one compiler per source, all at once.
   The five end-to-end workloads below are simulated meanwhile, in
   four worker processes, once each into build/smoke_inputs/;
3. kernel vs plain on the card, with the times of both (float32,
   rtol=2e-4, atol=1e-7 unless bit-identical): K1/K2 against the plain
   forward-backward at the bench path's B=2, N=65,536, P=16 with A=2, at
   B=128, N=4096, P=32, K=16 and B=2, N=4096, P=16, and at B=2,
   N=8192, P=89, A=8 (K2's 256-thread tier); S1 against the plain
   sampling DP, bit for bit, for one masked iteration at the bench
   path's shape C=2, N=55,040, P=123 (its chase alone against the plain
   chase too), for 15 greedy iterations at C=2, N=4096, P=123 and for
   one iteration at C=2, N=4096, P=300; S1 past 1024 paths, bit for bit, at
   C=2, N=4096, P=1025/2049/4096/4097/6405 and at C=2, N=1024,
   P=8193/16,385 (past 1024 paths a thread-block cluster of CTAs per
   chromosome: each cluster's cudaOccupancyMaxActiveClusters reading
   printed first), and its time at N=55,040 for P=1024/2049/4096/6405;
   K3/K4 against their plain versions at the SV
   path's shape B=1, N=131,072, P=89, K=32, A=16, at B=2, N=8192, P=89
   with 97/2/1% of the columns at A=2/4/16 (where the whole chunked
   route in chunks of 2048 is held against the same route with the
   plain versions) and at B=32, N=4096, P=32, K=32, A=16.
   Their columns carry k-mers only on alleles they have and read
   counts from a true path pair (utils/multiallelic.py), so raw
   posteriors stay far from float32's underflow: every column's sum
   must exceed POST_FLOOR, and the columns, divided by their sums, are
   compared at the tolerance above. At every K3/K4 shape two launches
   must give the same bits, and a batch of B=3 chains at P=89 with
   padding (all-zero E after one chain's is_last, and one chain all
   padding) goes through K3/K4 against the plain versions too. K3/K4's
   cluster tier (128 < P <= 471: a thread-block cluster of CTAs a chain,
   the state in registers) is held against the plain versions at B=2,
   N=512, P=465 (mixed A, entry carries drawn positive), two launches
   bit-identical, and timed, each kernel's cudaOccupancyMaxActiveClusters
   reading printed first; so is the grid tier past it (P > 471: a
   cooperative grid of CTAs a chain, the column sums merged through L2)
   at B=1, N=16, P=1025 and at B=1, N=64, P=2049 (the band in shared
   memory), each with its CTAs a chain, where the band lives and the
   CTAs the card holds at once. K1 and K2 run their one-warp tier at P
   <= 32 and A <= 8 (one rule for both, pg_fb_threads in csrc/fb.cu; K2 at
   the bench shape at A=2 printed beside the time of the kernel it
   replaced) and their 256-thread tier at 32 < P <= 128. Each
   kernel's bound (hmm/bounds.py: bytes over 3.35 TB/s or operations
   over 67 TFLOP/s, the larger) is printed beside its time, with the
   bytes/s achieved;
   then one chromosome of N=2,300,000 columns at P=123, over the old
   1 GiB rule for int32 backtraces: S1's best must equal the path's score
   summed again on the host, two greedy iterations must give paths apart
   in every column, and their peak device memory must stay within
   sampling.group_peak_bytes;
   then the checkpointed scan S1-seg: against the full S1 at C=1,
   N=200,000, P=2049 and at C=1, N=100,000, P=6405 (the cluster sweep)
   in 8 segments, and against its plain version at N=4096, P=6405, bit
   for bit; and one chromosome of N=2,300,000 at
   P=6405 (14.7 G cells, beyond one card) in the longest segments the
   free memory allows, inputs drawn on the card a segment at a time,
   path and host score checked as above, the scan's kernels timed by
   torch.profiler;
   then the two forward-backward routes on the same columns, with no
   forced chunk: the fused one (emissions, K1, K2) and the generic one
   (bucketed emissions, K3/K4, collapse), at the bench path's B=2,
   N=65,536, P=16, A=2 and at B=2, N=8192, P=89 with the 97/2/1% mix of
   A=2/4/16, in turns; their posteriors must agree;
4. end to end: the bench workload (20 Mb, 2 chromosomes, 61 samples =
   123 paths, 12x 150 bp reads, seed 11) genotyped and phased with the
   port's ``single -g -p`` on CUDA; the run must count read k-mers
   through D1-count (the graph table given), dispatch to the fused
   kernels, launch K1, K2, S1 (sweep and chase) and V1 (the phasing
   Viterbi, one launch a phasing batch), write a phasing VCF of every
   variant, load the native k-mer engine and reach genotype concordance
   >= 0.99 against the truth;
5. profile: the same command once more under torch.profiler; its VCF
   bodies must equal the first run's, and the device's busy time and
   idle share over the run are printed; then the batch the run handed to
   the fused route (its own columns and padded A, so the K1/K2 instances
   it took): K1/K2 against the plain versions and timed, K1 against the
   256-thread kernel its one-warp tier replaced, launched on the same
   batch for this (K1_CTA: the same bits, or the phase fails) and timed
   beside it, and the two routes on it, in turns; then the batch the run
   phased: V1 against its plain version on its first 8,192 columns (the
   same states, or where they part two paths that tie within 1e-6
   relative rescored in float64, printed with the column; exit carries
   the same bits or within 1e-5), V1 again on the whole batch (the run's
   states) and timed beside its bound; and, in a worker process beside
   the SV panel's phase, the port's float64 run of the same phasing runs
   on the CPU, whose phasing VCF is held against the run's after that
   phase, the lines that differ printed (no gate);
6. SV panel: one 20 Mb chromosome (about 150,000 variants, so more than
   2^17 HMM columns), 44 samples = 89 paths (no auto-sampling), 1% SV
   sites each rewritten into 8-15 distinct 100-400 bp insertion ALTs,
   12x 150 bp reads, seed 13; ``index`` then ``genotype -f`` on CUDA.
   The run must build its k-mer table on the card (D1-extract) and
   count through D1-count, dispatch to the generic kernels, launch K3
   and K4, walk
   the chromosome in more than one chunk and reach concordance >= 0.98;
   then ``genotype -f -g -p`` (genotyping and phasing over 30 paths)
   under torch.profiler, for the device time by kernel (K3+K4 and V1
   apart) and the idle share: its genotyping VCF body must equal the
   first run's but for INFO's UK and the sample's KC, which under -p are
   the phasing run's (the reference stores that run's results and
   combines the genotyping likelihoods into them), V1 must launch and
   its phasing VCF hold every variant;
   then V1 on that run's phasing batch (the chromosome padded to
   N=262,144, P=30): against its plain version on its first 4,096
   columns and again at full N, as the bench run's batch (phase 5), and
   through ``viterbi.viterbi`` in one launch and under a budget that
   makes at least 4 segments, the same states;
   then D1 on the first 250,000 reads of the bench and of the SV reads,
   each packed as one block (within the block the commands stream at
   the default -e): the table (the bench run's graph table given; the
   SV one built on the card from the index's path segments, equal to
   the host's key set), D1-extract's keys and D1-count's counts equal
   to their plain versions', the counts equal to the host engine's on
   the same reads, both timed beside their bounds, their plain versions
   and, for D1-count, torch.searchsorted then torch.bincount; and
   D1-extract on the SV corpus's first round, as the table build
   launches it;
7. large panel: one 2 Mb chromosome, 1024 samples = 2049 paths, 12x
   150 bp reads, seed 17; ``index``, ``genotype -f`` (auto-sampling: S1
   past 1024 paths, then K1/K2 at 16 paths; concordance >= 0.98, the
   first greedy path equal to the plain DP's, S1 timed on its inputs)
   and ``sampling -x 15`` (a panel VCF of 15 + 1 haplotypes, a paths
   TSV, and the same paths through the checkpointed scan under a forced
   budget); then ``genotype -f -a 200`` (11 path subsets of 200 paths:
   dispatch cuda_generic, K3/K4's cluster tier alone, concordance >=
   0.98), its launches counted alone, then once more under
   torch.profiler (both runs from an emptied allocator cache, so K3/K4's
   chunk, sized from the free memory, is the same: same chunks, same VCF
   body; the cluster tier's device time); then
   the cluster tier held against the plain versions and timed at the
   chunk shape (B, chunk, P=200) that run took, with drawn columns;
8. widest panel: one 1 Mb chromosome, 3202 samples (the 1000 Genomes
   high-coverage callset's) = 6405 paths, 12x 150 bp reads, seed 19;
   ``index`` and ``sampling -x 15`` (S1's cluster sweep; the first
   greedy path equal to the plain DP's, S1 timed on its inputs; a panel
   VCF of 15 + 1 haplotypes and a paths TSV);
9. wide-subsets panel: one 0.2 Mb chromosome, 300 samples = 601 paths,
   12x 150 bp reads, seed 29; ``index`` and ``genotype -f -a 600`` (two
   subsets of 600 paths, past what a cluster holds: dispatch
   cuda_generic, K3/K4's grid tier alone, concordance >= 0.98), its
   launches counted alone; then the grid tier held against the plain
   versions and timed at the chunk shape that run took;
10. multi-GPU (M1), each rank a process of this script
   (``--rank-job``) joined through a TCP store on localhost, the
   variables the port reads set: (a) world 1 over NCCL: the partitioned
   read k-mer counter (``count_file_primed_sharded``) on phase 6's block
   of the bench reads, its counts equal to D1-count's, then
   ``dryrun_multigpu(1)``; (b) two ranks sharing the card over gloo
   (NCCL takes one rank a card): the bench ``single -g -p`` of phase 4
   through the CLI, the coordinator's VCF bodies equal to phase 4's,
   both ranks on cuda:0 launching D1-count and S1, and between them K1,
   K2 and V1 (round-robin gives the phasing items to one rank, the
   genotyping items to the other); then the partitioned counter over
   the SV table built on the card (a partition a rank) on phase 6's
   block of the SV reads, its counts equal to phase 6's; then the SV
   ``genotype -f`` of phase 6 through the CLI with ``table_fits``
   patched to refuse the whole table and take a half, so that
   ``_read_counter`` takes its partitioned route: the coordinator's VCF
   body equal to phase 6's first run's, its counts equal to one process's D1 count
   of every SV read, and D1-count-keys' launches in the ``kernels`` line
   taken from this run alone; each rank's walls printed; (c) ``run_grid_local_sharded`` with [cuda:0, cuda:0]
   on the bench run's own fused and phasing batches, bit-identical to
   the single call; (d) D1-count-keys on the SV block's valid keys
   routed into 2 and 4 partitions of the SV table: every partition's
   counts equal to the plain version's and to D1-count's, partition 0
   timed beside its bound, its plain version and torch.searchsorted then
   torch.bincount, and the routing (owner, sort, sizes) timed.

Each end-to-end path, and the chromosome beyond one card, runs with
every kernel's launch count set to 0 just before it and read just
after; runs under torch.profiler give no launch counts and no walls but
their own. The last three lines of standard output are the kernels'
JSON record (launches from those paths; times, bound, bytes and us per
column at their shapes), the GPU's name and power limit, and the device
JSON record. The script imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

RTOL, ATOL = 2e-4, 1e-7
# a column of raw posteriors summing to less has underflowed (float32's
# smallest normal is 1.2e-38; the test columns' sums stay above 1e-12)
POST_FLOOR = 1e-20
# (B, N, P, K, A) of K1/K2's synthetic checks: the bench path's B, N
# and P at A=2 (its time beside K2_BEFORE_MS), bench.py's kernel cell, a
# short chain, and K2's 256-thread tier (32 < P <= 128) at A=8. The bench
# run's own batch (its columns, padded to A=4) is checked after that run
# (check_bench_columns).
FB_SHAPES = [(2, 65536, 16, 16, 2), (128, 4096, 32, 16, 2), (2, 4096, 16, 16, 2),
             (2, 8192, 89, 16, 8)]
# the first FB_SHAPES entry is held against the plain versions on this
# many columns and timed at its full N (the plain loops take a minute and
# a half at N=65,536; the bench run's own batch is held in full)
FB_PLAIN_COLUMNS = 16384
MAIN_S1_SHAPE = (2, 55040, 123, 4)                     # (C, N, P, A)
S1_GREEDY_SHAPE = (2, 4096, 123, 4, 15)                # (C, N, P, A, iterations)
# over the old 1 GiB rule for int32 [N, P] backtraces (2^28 cells)
LONG_S1_SHAPE = (1, 2_300_000, 123, 4)                 # (C, N, P, A)
# S1 past 1024 paths: bit checks at (C, N) for each P; times at the bench
# chromosomes' N (C, N, paths)
WIDE_S1_PATHS = (1025, 2049, 4096, 4097, 6405)
WIDE_S1_CHECK = (2, 4096)
# the cluster tier's wider edges (8 CTAs of 9 and 17 warps, the runtime-W
# instance), bit checks at
# (C, N, paths)
CLUSTER_S1_CHECK = (2, 1024, (8193, 16385))
# past what a cluster holds in registers: one CTA of 1024 threads, the
# scores in a scratch row, 32-bit backtraces (s1_sweep_many_kernel),
# bit check at (C, N, P)
SCRATCH_S1_CHECK = (1, 6, 65_537)
WIDE_S1_TIMES = (2, 55040, (1024, 2049, 4096, 6405))
# S1-seg against the full S1 where both fit: (C, N, P, segments), one
# CTA and a cluster a chromosome
SEG_CHECK_SHAPES = [(1, 200_000, 2049, 8), (1, 100_000, 6405, 8)]
# S1-seg's plain version on the card: (C, N, P, segment)
SEG_PLAIN_SHAPE = (1, 4096, 6405, 512)
# beyond one card: LONG_S1_SHAPE's length at P=6405, 14.7 G [N, P] cells
BEYOND_SHAPE = (1, 2_300_000, 6405)
# (B, N, P, K, mixed allele counts, forced chunk), all at A=16; the first
# is the SV path's shape (its first chunk: fb_generic.SEGMENT columns)
GENERIC_SHAPES = [(1, 1 << 17, 89, 32, True, 0), (2, 8192, 89, 32, True, 2048),
                  (32, 4096, 32, 32, False, 0)]
# (B, N, P, padded chain, padding from) of the padding check
PADDED_SHAPE = (3, 2048, 89, 2, 1500)
# K3/K4 past 128 paths, with the 97/2/1% mix at A=16: (B, N, P, K). The
# cluster tier at HPRC release 2's 464 haplotypes and the reference, and
# the grid tier past it on short chunks: its band in registers at P=1025,
# in shared memory at the large panel's 2049 paths genotyped unsampled.
# The large panel's `genotype -f -a 200` chunk shape (the cluster tier)
# and the wide-subsets panel's `genotype -f -a 600` one (the grid tier)
# are checked after those runs (check_wide with the shape each walk
# recorded).
WIDE_SHAPES = [(2, 512, 465, 32), (1, 16, 1025, 32), (1, 64, 2049, 32)]
# path subsets of `genotype -f -a` on the large panel
LARGE_SUBSET = 200
# the two routes timed on the same columns with no forced chunk: the
# bench path's shape (B, N, P, K, A) at A=2 and the mixed-A shape at P=89
# of benchmarks/bench_sv_sampling.py (the bench run's own batch after
# that run)
ROUTE_SHAPES = [(2, 65536, 16, 16, 2), (2, 8192, 89, 32, 16)]
# K2 at the bench path's shape before its one-warp tier, on an NVIDIA H100
# 80GB HBM3 at 700 W (PERF.md; tools/k2_times.py times both in one run)
K2_BEFORE_MS = 207.029
# K1 on the bench run's own batch (B=2 N=65,536 P=16 A=4) before its
# one-warp tier, the 256-thread kernel, on an NVIDIA H100 80GB HBM3 at
# 700 W (PERF.md; tools/k2_times.py --root times the parent beside it)
K1_BEFORE_MS = 148.622
# K3/K4 at the SV path's shape, as the redesign's acceptance set them (ms)
GENERIC_TARGETS = {"K3": 550.0, "K4": 730.0}
# the bench run's phasing batch is held against V1's plain version (a
# per-column torch loop) on this many columns; V1 is timed at its full N
V1_PLAIN_COLUMNS = 8192
# where V1's and the plain version's states part, the two paths rescored
# in float64 from the same inputs must agree this closely (relative): a
# near-tie broken by the last ulp of a column's logsumexp; their exit
# carries (log values) must agree to this, absolute, where their bits
# differ
V1_TIE_RTOL = 1e-6
V1_CARRY_ATOL = 1e-5
# the SV panel's phasing batch (P=30, S=900: the plain version's columns
# cost about 3.5x the bench batch's) is held against the plain version on
# this many columns, and walked again in at least this many segments
SV_V1_PLAIN_COLUMNS = 4096
SEGMENTS_AT_LEAST = 4
# D1 is held and timed on the first reads of a run's read stream, as one
# block of the size the commands stream at the default -e (3e9 // 64
# bases); 250,000 reads of 150 bases take 1,250,000 of its 1,464,843
# pieces of 32 bases
D1_BLOCK_BASES = 3_000_000_000 // 64
D1_SLICE_READS = 250_000
# the bench workload (bench.py:191-192, not cut) and the SV panel
BENCH = dict(mb=20.0, chroms=2, samples=61, distance=150, seed=11)
SV_PANEL = dict(mb=20.0, chroms=1, samples=44, distance=100, seed=13,
                sv_fraction=0.01, sv_alts=(8, 15))
# a large panel: 1024 samples = 2049 paths with the reference, cut to 2 Mb
LARGE_PANEL = dict(mb=2.0, chroms=1, samples=1024, distance=150, seed=17,
                   vector_genotypes=True)
# the widest panel: the 1000 Genomes high-coverage phased callset's 3202
# samples = 6405 paths with the reference, cut to 1 Mb
WIDEST_PANEL = dict(mb=1.0, chroms=1, samples=3202, distance=150, seed=19,
                    vector_genotypes=True)
# path subsets past what a cluster of CTAs holds (K3/K4's grid tier):
# `genotype -f -a WIDE_SUBSET` on 300 samples = 601 paths, cut to 0.2 Mb
WIDE_SUBSET_PANEL = dict(mb=0.2, chroms=1, samples=300, distance=150, seed=29,
                         vector_genotypes=True)
WIDE_SUBSET = 600


def phase(name):
    print(f"== {name}", flush=True)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()


def timed(fn):
    """(fn(), device ms of that one call)."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn over reps launches, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def against_bound(t: dict, key: str) -> str:
    """The kernel's time beside its least time (hmm/bounds.py), and the
    bytes/s it achieved, from a check's times ``t``."""
    work = t[key + "_work"]
    bound, by = work.bound()
    return (f"{key} bound {bound:.4f} ms by {by} ({work.nbytes} bytes), "
            f"{work.nbytes / (t[key] / 1e3) / 1e9:.1f} GB/s achieved, "
            f"{t[key] * 1e3 / t[key + '_cols']:.3f} us per column")


def fused_tier(P: int, A: int) -> str:
    """K1's and K2's tier for P paths and A alleles (one rule for both)."""
    from pangenie_tpu_torch.hmm import fb_kernels

    threads = fb_kernels.K1.lib().pg_fb_threads(P, A)
    return "one warp a chain" if threads == 32 else f"{threads} threads a chain"


def hold_fb(cols, what: str, gpu: str, parent_ms=None, timed_cols=None, k1_parent_ms=None):
    """K1 and K2 against the plain forward-backward on the columns
    ``cols``, timed beside their bounds on ``timed_cols`` (default
    ``cols``); ``parent_ms`` / ``k1_parent_ms`` are printed beside K2's /
    K1's time. Returns the times, with K1's and K2's largest absolute
    errors and their tier."""
    import torch

    from pangenie_tpu_torch.hmm import bounds, fb_kernels
    from pangenie_tpu_torch.hmm.forward_backward import (
        allele_emissions, backward_plain, forward_plain,
    )

    ea = allele_emissions(cols)
    al, tr, last = cols.allele_local, cols.trans, cols.is_last
    B, N, P = al.shape
    A = ea.shape[-1]
    (a_k, c_k), _ = timed(lambda: fb_kernels.forward(ea, al, tr))
    (a_p, c_p), k1_plain = timed(lambda: forward_plain(ea, al, tr))
    torch.testing.assert_close(a_k, a_p, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(c_k, c_p, rtol=RTOL, atol=ATOL)
    p_k, _ = timed(lambda: fb_kernels.backward(a_k, c_k, ea, al, tr, last))
    p_p, k2_plain = timed(lambda: backward_plain(a_p, c_p, ea, al, tr, last))
    torch.testing.assert_close(p_k, p_p, rtol=RTOL, atol=ATOL)
    e1 = max(float((a_k - a_p).abs().max()), float((c_k - c_p).abs().max()))
    e2 = float((p_k - p_p).abs().max())
    if timed_cols is not None:
        plain_n = N
        del ea, a_k, c_k, a_p, c_p, p_k, p_p
        ea = allele_emissions(timed_cols)
        al, tr, last = timed_cols.allele_local, timed_cols.trans, timed_cols.is_last
        B, N, P = al.shape
        a_k, c_k = fb_kernels.forward(ea, al, tr)
        what = f"{what} (plain on its first {plain_n} columns)"
    t = {
        "K1": cuda_ms(lambda: fb_kernels.forward(ea, al, tr), 3),
        "K1_plain": k1_plain,
        "K2": cuda_ms(lambda: fb_kernels.backward(a_k, c_k, ea, al, tr, last), 3),
        "K2_plain": k2_plain,
        "K1_work": bounds.k1(B, N, P, A), "K1_cols": N,
        "K2_work": bounds.k2(B, N, P, A), "K2_cols": N,
        "shape": f"B={B} N={N} P={P} A={A}", "K1_err": e1, "K2_err": e2,
        "tier": fused_tier(P, A),
    }
    print(f"  fb {what}: ok (K1 max_abs_err {e1:.3e}, K2 max_abs_err {e2:.3e})")
    tier = t["tier"]
    parent = f" (the 256-thread kernel before: {parent_ms} ms)" if parent_ms else ""
    k1_parent = (f" (the 256-thread kernel before: {k1_parent_ms} ms)" if k1_parent_ms
                 else "")
    print(f"  times {what} [{gpu}]: K1 ({tier}) {t['K1']:.3f} ms{k1_parent}, plain "
          f"{t['K1_plain']:.3f} ms; K2 ({tier}) {t['K2']:.3f} ms{parent}, plain "
          f"{t['K2_plain']:.3f} ms; {against_bound(t, 'K1')}; "
          f"{against_bound(t, 'K2')}", flush=True)
    return t


def check_fb(device, gpu) -> None:
    """K1/K2 against the plain forward-backward at every FB_SHAPES entry."""
    import torch

    from pangenie_tpu_torch.hmm.forward_backward import columns_from_numpy
    from pangenie_tpu_torch.utils.synthetic import synthetic_columns

    def columns(B, N, P, K, A):
        return columns_from_numpy(
            synthetic_columns(n_columns=N, n_paths=P, n_kmers=K, n_alleles=A,
                              batch_dims=(B,), seed=7, dtype="float32"),
            device, torch.float32,
        )

    for B, N, P, K, A in FB_SHAPES:
        first = (B, N, P, K, A) == FB_SHAPES[0]
        cols = columns(B, FB_PLAIN_COLUMNS if first else N, P, K, A)
        hold_fb(cols, f"B={B} N={N} P={P} K={K} A={A}", gpu,
                K2_BEFORE_MS if first else None,
                columns(B, N, P, K, A) if first else None)
        del cols
        torch.cuda.empty_cache()


def check_bench_columns(cols, gpu):
    """K1/K2 on the bench run's own fused batch (the padded A it had, so
    the K1/K2 instances it took) against the plain versions, timed; K1
    against the 256-thread kernel it replaced there (K1_CTA), which must
    give the same bits (so the VCF does not depend on K1's tier), timed
    on the same batch; then the two routes on those columns
    (:func:`time_routes`). Returns the errors and times."""
    import torch

    from pangenie_tpu_torch.hmm import fb_kernels
    from pangenie_tpu_torch.hmm.forward_backward import allele_emissions

    B, N, P = cols.allele_local.shape
    A = cols.incidence.shape[-1]
    what = f"the bench run's batch B={B} N={N} P={P} A={A}"
    t = hold_fb(cols, what, gpu, k1_parent_ms=K1_BEFORE_MS)
    ea = allele_emissions(cols)
    al, tr = cols.allele_local, cols.trans
    got = fb_kernels.forward(ea, al, tr)
    cta = fb_kernels.forward(ea, al, tr, fb_kernels.K1_CTA)
    same = all(torch.equal(g.view(torch.int32), c.view(torch.int32))
               for g, c in zip(got, cta))
    t["K1_cta"] = cuda_ms(lambda: fb_kernels.forward(ea, al, tr, fb_kernels.K1_CTA), 3)
    print(f"  K1 {what} [{gpu}]: {t['K1']:.3f} ms ({t['tier']}) against the 256-thread "
          f"kernel's {t['K1_cta']:.3f} ms on the same batch in this run; outputs "
          f"{'the same bits' if same else 'NOT the same bits'}", flush=True)
    assert same, "K1's one-warp tier does not give the 256-thread kernel's bits"
    del ea, got, cta
    time_routes(cols, what, gpu)
    return t


def s1_iteration_inputs(rng, C, N, P, A, device):
    """Capped costs as the penalty updates leave them (<= 25) gathered
    through alleles as a panel carries them, a third of the paths masked
    as after a few greedy iterations, switch costs on the scale of real
    ones (tools/s1_times.py builds the same)."""
    import numpy as np
    import torch

    costs = torch.from_numpy(rng.integers(0, 26, (C, N, A)).astype(np.int32)).to(device)
    alleles = torch.from_numpy(rng.integers(0, A, (C, N, P))).to(device)
    path_cost = torch.gather(costs, 2, alleles).to(torch.int32).contiguous()
    mask = torch.from_numpy(rng.random((C, N, P)) > 0.3).to(device)
    switch = torch.from_numpy(rng.integers(20, 40, (C, N)).astype(np.int32)).to(device)
    return path_cost, mask, switch


def check_s1(device, gpu):
    """S1 against the plain sampling DP, bit for bit: one masked
    iteration at the main path's shape (the chase alone against its
    plain version too), the greedy loop, and one iteration at P=300 (the
    multi-warp sweep, 16-bit backtraces). Returns the largest absolute
    difference (0) and the times at the main path's shape: S1 is the
    whole function (sweep and chase), S1_CHASE the chase alone."""
    import numpy as np
    import torch

    from pangenie_tpu_torch.hmm import bounds, sampling
    from pangenie_tpu_torch.hmm.sampling import (
        sample_group, viterbi_iteration, viterbi_iteration_plain,
    )

    rng = np.random.default_rng(5)
    C, N, P, A = MAIN_S1_SHAPE
    path_cost, mask, switch = s1_iteration_inputs(rng, C, N, P, A, device)
    (pk, sk), _ = timed(lambda: viterbi_iteration(path_cost, mask, switch))
    (pp, sp), s1_plain = timed(lambda: viterbi_iteration_plain(path_cost, mask, switch))
    if not (torch.equal(pk, pp) and torch.equal(sk, sp)):
        raise AssertionError("S1 paths or scores differ from the plain DP "
                             "at the main path's shape")
    max_err = max(float((pk.long() - pp.long()).abs().max()),
                  float((sk - sp).abs().max()))
    bt, _best, ends, _ = sampling.s1_sweep(path_cost, mask, switch)
    chase_k = sampling.s1_chase(bt, ends, P)[0]
    chase_p, chase_plain_ms = timed(lambda: sampling.chase_plain(bt, ends)[0])
    if not (torch.equal(chase_k, chase_p) and torch.equal(chase_k, pk)):
        raise AssertionError("S1's chase differs from its plain version")
    t = {"S1": cuda_ms(lambda: viterbi_iteration(path_cost, mask, switch), 3),
         "S1_plain": s1_plain, "S1_work": bounds.s1(C, N, P), "S1_cols": N,
         "sweep": cuda_ms(lambda: sampling.s1_sweep(path_cost, mask, switch), 3),
         "S1_CHASE": cuda_ms(lambda: sampling.s1_chase(bt, ends, P), 3),
         "S1_CHASE_plain": chase_plain_ms, "S1_CHASE_cols": N,
         "S1_CHASE_work": bounds.s1_chase(C, N, bt.element_size())}
    print(f"  s1 C={C} N={N} P={P}, one masked iteration: bit-identical "
          f"(paths and scores); the chase alone equals its plain version")
    print(f"  times C={C} N={N} P={P} [{gpu}]: S1 {t['S1']:.3f} ms (sweep "
          f"{t['sweep']:.3f} ms, chase {t['S1_CHASE']:.3f} ms in segments of "
          f"{sampling.chase_segment(N)}), plain {t['S1_plain']:.3f} ms per iteration; "
          f"{against_bound(t, 'S1')}; chase plain {chase_plain_ms:.3f} ms, "
          f"{against_bound(t, 'S1_CHASE')}", flush=True)
    del path_cost, mask, switch, bt

    C, N, P, A = 2, 4096, 300, 4
    path_cost, mask, switch = s1_iteration_inputs(rng, C, N, P, A, device)
    got = viterbi_iteration(path_cost, mask, switch)
    want, plain_ms = timed(lambda: viterbi_iteration_plain(path_cost, mask, switch))
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"S1 paths or scores differ from the plain DP at P={P}")
    wide_ms = cuda_ms(lambda: viterbi_iteration(path_cost, mask, switch), 3)
    print(f"  s1 C={C} N={N} P={P} ({s1_layout(P)}, "
          f"{sampling.backtrace_dtype(P)} backtraces): bit-identical; [{gpu}] "
          f"{wide_ms:.3f} ms, plain {plain_ms:.3f} ms", flush=True)
    del path_cost, mask, switch

    C, N, P, A, iters = S1_GREEDY_SHAPE
    # costs 0..3 force ties; switch costs on the scale of real ones
    costs = torch.from_numpy(rng.integers(0, 4, (C, N, A)).astype(np.int32)).to(device)
    alleles = torch.from_numpy(rng.integers(0, A, (C, N, P)).astype(np.int32)).to(device)
    switch = torch.from_numpy(rng.integers(1, 12, (C, N)).astype(np.int32)).to(device)
    valid = torch.ones((C, N), dtype=torch.bool, device=device)
    valid[1, N - 100:] = False
    paths_k, s1_ms = timed(lambda: sample_group(costs, alleles, switch, valid, iters, 5))
    paths_p, plain_ms = timed(lambda: sample_group(
        costs, alleles, switch, valid, iters, 5, viterbi=viterbi_iteration_plain))
    if not torch.equal(paths_k, paths_p):
        raise AssertionError("S1 greedy paths differ from the plain sampling DP")
    max_err = max(max_err, float((paths_k.long() - paths_p.long()).abs().max()))
    print(f"  s1 C={C} N={N} P={P} x{iters} greedy iterations: bit-identical; "
          f"[{gpu}] {s1_ms:.3f} ms with S1, {plain_ms:.3f} ms plain", flush=True)
    return max_err, t


def check_long_chromosome(device, gpu) -> None:
    """S1 on one chromosome of LONG_S1_SHAPE, over the old rule of 1 GiB
    of int32 backtraces, inputs made on the card from a seeded
    torch.Generator: one iteration with a third of the paths masked,
    whose path must avoid every masked cell and whose score, summed again
    on the host in int64 with uint32 saturation, must equal S1's best;
    then 2 greedy iterations through sample_group, whose second path
    must leave the first's in every column. The peak device memory of
    those is held against sampling.group_peak_bytes, the budget
    sample_panels_batched checks."""
    import numpy as np
    import torch

    from pangenie_tpu_torch.hmm import sampling

    C, N, P, A = LONG_S1_SHAPE
    assert N * P * 4 > 1 << 30
    g = torch.Generator(device=device)
    g.manual_seed(23)
    t0 = time.monotonic()
    path_cost = torch.randint(0, 26, (C, N, P), generator=g, device=device, dtype=torch.int32)
    mask = torch.rand((C, N, P), generator=g, device=device) > 1 / 3
    switch = torch.randint(20, 40, (C, N), generator=g, device=device, dtype=torch.int32)
    (paths, best), s1_ms = timed(lambda: sampling.viterbi_iteration(path_cost, mask, switch))
    cols = torch.arange(N, device=device)
    on_path = paths[0].long()
    if not bool(mask[0, cols, on_path].all()):
        raise AssertionError("the long chromosome's path steps on a masked cell")
    cost = path_cost[0, cols, on_path].cpu().numpy().astype(np.int64)
    p = on_path.cpu().numpy()
    sw = switch[0].cpu().numpy().astype(np.int64)
    score = min(int(cost.sum() + sw[1:][p[1:] != p[:-1]].sum()), sampling.UINT_MAX)
    if score != int(best[0]):
        raise AssertionError(f"long chromosome: the path scores {score} on the host, "
                             f"S1 says {int(best[0])}")
    print(f"  long chromosome C={C} N={N} P={P}: path avoids every masked cell, host "
          f"score {score} == S1 best; [{gpu}] one iteration {s1_ms:.3f} ms", flush=True)
    del path_cost, mask, paths, cols, on_path

    base = torch.cuda.memory_allocated()
    costs = torch.randint(0, 26, (C, N, A), generator=g, device=device, dtype=torch.int32)
    alleles = torch.randint(0, A, (C, N, P), generator=g, device=device, dtype=torch.int32)
    valid = torch.ones((C, N), dtype=torch.bool, device=device)
    torch.cuda.reset_peak_memory_stats()
    sampled, greedy_ms = timed(lambda: sampling.sample_group(costs, alleles, switch, valid, 2, 10))
    peak = torch.cuda.max_memory_allocated() - base
    if not bool((sampled[0] != sampled[1]).all()):
        raise AssertionError("the second greedy path shares a column with the first")
    predicted = sampling.group_peak_bytes(C, N, P, A, 2)
    budget = sampling.memory_budget(device)
    print(f"  long chromosome x2 greedy iterations: second path differs in every "
          f"column; [{gpu}] {greedy_ms:.3f} ms; peak device memory {peak} bytes "
          f"({peak / (C * N * P):.2f} per [N,P] cell), group_peak_bytes {predicted} "
          f"({predicted / (C * N * P):.2f} per cell), budget now {budget} bytes; phase "
          f"{time.monotonic() - t0:.1f} s", flush=True)
    if peak > predicted:
        raise AssertionError(f"measured peak {peak} > group_peak_bytes {predicted}")
    del costs, alleles, valid, switch, sampled
    torch.cuda.empty_cache()


def card_s1_inputs(g, C, N, P, device, A=4):
    """:func:`s1_iteration_inputs`' distributions drawn on the card from
    the generator ``g`` (for shapes whose inputs are slow to draw on the
    host)."""
    import torch

    costs = torch.randint(0, 26, (C, N, A), generator=g, device=device, dtype=torch.int32)
    alleles = torch.randint(0, A, (C, N, P), generator=g, device=device)
    path_cost = torch.gather(costs, 2, alleles).contiguous()
    del alleles
    mask = torch.rand((C, N, P), generator=g, device=device) > 0.3
    switch = torch.randint(20, 40, (C, N), generator=g, device=device, dtype=torch.int32)
    return path_cost, mask, switch


def paths_error(got, want) -> float:
    """The largest absolute difference between two (paths, best) pairs."""
    return max(float((a.long() - b.long()).abs().max()) if a.numel() else 0.0
               for a, b in zip(got, want))


def s1_layout(P: int) -> str:
    """S1's sweep layout for P paths, in words."""
    from pangenie_tpu_torch.hmm import sampling

    ranks, warps, per_lane, _row = sampling.sweep_layout(P)
    cta = f"{warps} warps of {per_lane} paths a lane"
    if P > sampling.CLUSTER_PATHS:
        return f"1 CTA of {cta}, the scores in a scratch row"
    return f"a cluster of {ranks} CTAs of {cta}" if P > sampling.CTA_PATHS else cta


def check_s1_wide(device, gpu) -> None:
    """S1 past 1024 paths against the plain sampling DP, bit for bit, at
    C=2 N=4096 for every WIDE_S1_PATHS entry and at CLUSTER_S1_CHECK (a
    cluster of CTAs a chromosome, whose cudaOccupancyMaxActiveClusters
    reading is printed before its first launch), and at SCRATCH_S1_CHECK
    (one CTA, the scores in a scratch row); then S1's time at the bench chromosomes' N=55,040 for every
    P of WIDE_S1_TIMES beside its bound, inputs drawn on the card. (The
    kernels' record takes S1's times past 1024 paths from the panels'
    end-to-end runs, on their own inputs.)"""
    import numpy as np
    import torch

    from pangenie_tpu_torch.hmm import bounds, sampling
    from pangenie_tpu_torch.hmm.sampling import viterbi_iteration, viterbi_iteration_plain

    rng = np.random.default_rng(29)
    C, N = WIDE_S1_CHECK
    cluster_c, cluster_n, cluster_paths = CLUSTER_S1_CHECK
    for C, N, P in ([(C, N, P) for P in WIDE_S1_PATHS]
                    + [(cluster_c, cluster_n, P) for P in cluster_paths] + [SCRATCH_S1_CHECK]):
        if sampling.CTA_PATHS < P <= sampling.CLUSTER_PATHS:
            print(f"  s1 P={P}: {s1_layout(P)}; cudaOccupancyMaxActiveClusters: "
                  f"{sampling.cluster_fits(P)} such clusters fit the card", flush=True)
        inputs = s1_iteration_inputs(rng, C, N, P, 4, device)
        got = viterbi_iteration(*inputs)
        want, plain_ms = timed(lambda: viterbi_iteration_plain(*inputs))
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"S1 paths or scores differ from the plain DP at P={P}")
        print(f"  s1 C={C} N={N} P={P} ({s1_layout(P)}, {sampling.backtrace_dtype(P)} "
              f"backtraces): bit-identical (max_abs_err {paths_error(got, want)}); plain "
              f"{plain_ms:.3f} ms", flush=True)
        del inputs, got, want
    C, N, paths = WIDE_S1_TIMES
    g = torch.Generator(device=device)
    g.manual_seed(31)
    for P in paths:
        inputs = card_s1_inputs(g, C, N, P, device)
        t = {"S1": cuda_ms(lambda: viterbi_iteration(*inputs), 3),
             "S1_work": bounds.s1(C, N, P), "S1_cols": N}
        bt, _best, ends, _ = sampling.s1_sweep(*inputs)
        sweep_ms = cuda_ms(lambda: sampling.s1_sweep(*inputs), 3)
        chase_ms = cuda_ms(lambda: sampling.s1_chase(bt, ends, P), 3)
        del bt
        print(f"  times C={C} N={N} P={P} ({s1_layout(P)}) [{gpu}]: "
              f"S1 {t['S1']:.3f} ms (sweep {sweep_ms:.3f} ms, chase {chase_ms:.3f} ms); "
              f"{against_bound(t, 'S1')}", flush=True)
        del inputs
        torch.cuda.empty_cache()


def check_s1_seg(device, gpu):
    """S1-seg (sampling.viterbi_iteration_segmented through the kernels)
    against the full S1 where both fit, at each SEG_CHECK_SHAPES entry in
    segments short enough for at least that many: paths and best
    bit-identical;
    then against its plain version on the card at SEG_PLAIN_SHAPE.
    Returns the largest absolute difference of those comparisons and the
    plain version's time and shape."""
    import torch

    from pangenie_tpu_torch.hmm import sampling

    g = torch.Generator(device=device)
    g.manual_seed(37)
    inputs, err = None, 0.0

    def source(lo, hi):
        return tuple(t[:, lo:hi].contiguous() for t in inputs)

    for C, N, P, S in SEG_CHECK_SHAPES:
        inputs = card_s1_inputs(g, C, N, P, device)
        segment = -(-N // S)
        got, seg_ms = timed(lambda: sampling.viterbi_iteration_segmented(
            source, C, N, P, segment, device))
        want, full_ms = timed(lambda: sampling.viterbi_iteration(*inputs))
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"S1-seg differs from the full S1 at C={C} N={N} P={P}")
        err = max(err, paths_error(got, want))
        print(f"  s1-seg C={C} N={N} P={P} ({s1_layout(P)}) in {-(-N // segment)} segments "
              f"of {segment}: paths and best equal the full S1's (max_abs_err "
              f"{paths_error(got, want)}); [{gpu}] {seg_ms:.3f} ms (slices included), full "
              f"S1 {full_ms:.3f} ms", flush=True)
        del inputs, got, want

    C, N, P, segment = SEG_PLAIN_SHAPE
    inputs = card_s1_inputs(g, C, N, P, device)
    got, seg_ms = timed(lambda: sampling.viterbi_iteration_segmented(
        source, C, N, P, segment, device))
    want, plain_ms = timed(lambda: sampling.viterbi_iteration_segmented(
        source, C, N, P, segment, device, plain=True))
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"S1-seg differs from its plain version at C={C} N={N} P={P}")
    err = max(err, paths_error(got, want))
    shape = f"C={C} N={N} P={P} segments of {segment}"
    print(f"  s1-seg {shape}: bit-identical to its plain version (max_abs_err "
          f"{paths_error(got, want)}); [{gpu}] {seg_ms:.3f} ms, plain {plain_ms:.3f} ms",
          flush=True)
    del inputs
    torch.cuda.empty_cache()
    return err, plain_ms, shape


def beyond_source(device, C: int, P: int, seed: int):
    """The segments of a chromosome made on the card: columns lo..hi-1
    drawn from a torch.Generator seeded by ``seed + lo``, so a segment
    asked for again gives the same values. Costs 0..25, a third of the
    paths masked, switch costs 20..39; 6 bytes a cell while drawn."""
    import torch

    def source(lo, hi):
        g = torch.Generator(device=device)
        g.manual_seed(seed + lo)
        shape = (C, hi - lo, P)
        cost = torch.randint(0, 26, shape, generator=g, device=device, dtype=torch.int32)
        mask = torch.randint(0, 3, shape, generator=g, device=device, dtype=torch.uint8) > 0
        switch = torch.randint(20, 40, (C, hi - lo), generator=g, device=device,
                               dtype=torch.int32)
        return cost, mask, switch

    return source


def check_beyond_card(device, gpu):
    """One greedy iteration on a chromosome of BEYOND_SHAPE, whose full
    sweep does not fit the card, through the checkpointed scan in the
    longest segments the card's free memory allows, inputs drawn on the
    card a segment at a time (:func:`beyond_source`), under
    torch.profiler: S1-seg's time is the device time of its kernels (the
    sweeps and the chases' maps and re-walks), apart from the kernels
    that draw the inputs. The path must avoid every masked cell and its
    score, summed again on the host in int64 with uint32 saturation,
    equal the scan's best. Kernel launch counts are set to 0 just before
    the scan and read just after. Returns the times and launches for the
    kernels' record."""
    import numpy as np
    import torch

    from pangenie_tpu_torch.hmm import bounds, sampling

    C, N, P = BEYOND_SHAPE
    torch.cuda.empty_cache()
    budget = sampling.memory_budget(device)
    if sampling.group_peak_bytes(C, N, P, 4, 1) <= budget:
        raise AssertionError(f"{N} x {P} fits the card's {budget} bytes: not beyond it")
    source = beyond_source(device, C, P, seed=41)
    segment = sampling.segment_columns(budget, C, N, P, 6 * P + 4)
    bounds_ = [(lo, min(N, lo + segment)) for lo in range(0, N, segment)]
    out = {}

    def scan():
        out["paths"], out["best"] = sampling.viterbi_iteration_segmented(
            source, C, N, P, segment, device)

    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    wall, busy, by_name = profile_device(scan)
    paths, best = out.pop("paths"), out.pop("best")
    kernel_ms = 1e3 * sum(dt for name, (dt, _n) in by_name.items()
                          if any(k in name for k in ("s1_sweep", "s1_maps", "s1_rewalk")))
    launches = {"S1": sampling.S1.launches, "S1_CHASE": sampling.S1_CHASE.launches}
    peak = torch.cuda.max_memory_allocated()
    S = len(bounds_)
    if launches != {"S1": 2 * S - 1, "S1_CHASE": S}:
        raise AssertionError(f"launches {launches} for {S} segments")
    on_path = paths[0].long()
    costs, switches = [], []
    for lo, hi in bounds_:
        cost, mask, switch = source(lo, hi)
        cols = torch.arange(hi - lo, device=device)
        if not bool(mask[0, cols, on_path[lo:hi]].all()):
            raise AssertionError("the path beyond one card steps on a masked cell")
        costs.append(cost[0, cols, on_path[lo:hi]].cpu().numpy().astype(np.int64))
        switches.append(switch[0].cpu().numpy().astype(np.int64))
        del cost, mask, switch
    p = on_path.cpu().numpy()
    sw = np.concatenate(switches)
    score = min(int(np.concatenate(costs).sum() + sw[1:][p[1:] != p[:-1]].sum()),
                sampling.UINT_MAX)
    if score != int(best[0]):
        raise AssertionError(f"beyond one card: the path scores {score} on the host, "
                             f"S1-seg says {int(best[0])}")
    swept = N + bounds_[-1][0]  # the reverse pass and the forward one
    print(f"  beyond one card C={C} N={N} P={P} ({C * N * P} cells; budget {budget} bytes, "
          f"full sweep's group peak {sampling.group_peak_bytes(C, N, P, 4, 1)}): {S} "
          f"segments of {segment}, path avoids every masked cell, host score {score} == "
          f"S1-seg best; [{gpu}] profiled wall {wall:.2f} s, device busy {busy * 1e3:.3f} ms "
          f"of which S1-seg's kernels {kernel_ms:.3f} ms over {swept} swept columns "
          f"({kernel_ms * 1e3 / swept:.3f} us a column a pass); peak device memory "
          f"{peak} bytes; launches {launches}", flush=True)
    del paths, on_path
    torch.cuda.empty_cache()
    t = {"S1_SEG": kernel_ms, "S1_SEG_work": bounds.s1_seg(C, N, P, segment),
         "S1_SEG_cols": N}
    return t, launches


def generic_columns(B, N, P, K, mixed, seed, device):
    """Columns with A=16 alleles (benchmarks/bench_sv_sampling.py:36);
    with ``mixed``, 97/2/1% of the columns keep 2/4/16 of them, the
    profile of a real chromosome (bench_sv_sampling.py:122-165)."""
    import numpy as np
    import torch

    from pangenie_tpu_torch.hmm.forward_backward import columns_from_numpy
    from pangenie_tpu_torch.utils.multiallelic import allele_mix, multiallelic_columns

    caps = allele_mix(N, seed) if mixed else np.full(N, 16, dtype=np.int32)
    cols = multiallelic_columns(N, P, K, caps, batch_dims=(B,), seed=seed)
    return columns_from_numpy(cols, device, torch.float32)


def posterior_error(got, want, what: str):
    """Holds raw posteriors [..., X, X] column by column: no column's
    sum may fall to POST_FLOOR, the sums agree at RTOL, and the columns
    divided by their sums agree at RTOL/ATOL. Returns the largest
    absolute error of the divided columns and the smallest sum."""
    import torch

    s_got = got.sum(dim=(-2, -1), keepdim=True)
    s_want = want.sum(dim=(-2, -1), keepdim=True)
    low = min(float(s_got.min()), float(s_want.min()))
    if not low > POST_FLOOR:
        raise AssertionError(f"{what}: a column's posteriors sum to {low:.3e}, "
                             f"at or below {POST_FLOOR:.0e} (underflow)")
    torch.testing.assert_close(s_got, s_want, rtol=RTOL, atol=0)
    got, want = got / s_got, want / s_want
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    return float((got - want).abs().max()), low


@contextlib.contextmanager
def plain_generic_kernels():
    """Send the chunked route through the plain versions of K3/K4."""
    from pangenie_tpu_torch.hmm import fb_generic, fb_kernels

    saved = fb_kernels.forward_e, fb_kernels.backward_e
    fb_kernels.forward_e = fb_generic.forward_e_plain
    fb_kernels.backward_e = fb_generic.backward_e_plain
    try:
        yield
    finally:
        fb_kernels.forward_e, fb_kernels.backward_e = saved


def check_generic(device, gpu):
    """K3/K4 against their plain versions at every GENERIC_SHAPES entry,
    on the same inputs (K4 takes the kernel's alphas); K4's raw
    posteriors through :func:`posterior_error`. Where a chunk is forced,
    also the chunked route with the kernels against the same route with
    the plain versions (both timed). Returns the largest absolute errors (K4's: of the
    divided posteriors and of the outgoing beta) and the times at the SV
    path's shape."""
    import torch

    from pangenie_tpu_torch.hmm import bounds, fb_generic, fb_kernels

    err = {"K3": 0.0, "K4": 0.0}
    times = {}
    for B, N, P, K, mixed, chunk in GENERIC_SHAPES:
        cols = generic_columns(B, N, P, K, mixed, seed=17, device=device)
        E = fb_generic.bucketed_state_emissions(cols).reshape(B, N, P, P)
        u = fb_generic.factor_trans(cols.trans).contiguous()
        ones = torch.ones((B, P, P), device=device)
        e_after = torch.zeros((B, P, P), device=device)
        u_after = torch.zeros((B, 3), device=device)
        beta0 = torch.zeros((B, P, P), device=device)
        last = cols.is_last
        (a_k, c_k), _ = timed(lambda: fb_kernels.forward_e(E, u, ones))
        (a_p, c_p), k3_plain = timed(lambda: fb_generic.forward_e_plain(E, u, ones))
        torch.testing.assert_close(a_k, a_p, rtol=RTOL, atol=ATOL)
        torch.testing.assert_close(c_k, c_p, rtol=RTOL, atol=ATOL)
        e3 = max(float((a_k - a_p).abs().max()), float((c_k - c_p).abs().max()))
        del a_p, c_p
        bwd_args = (a_k, c_k, E, u, e_after, u_after, last, beta0)
        (p_k, b_k), _ = timed(lambda: fb_kernels.backward_e(*bwd_args))
        (p_p, b_p), k4_plain = timed(lambda: fb_generic.backward_e_plain(*bwd_args))
        e4_post, low = posterior_error(p_k, p_p, f"K4 at B={B} N={N} P={P}")
        torch.testing.assert_close(b_k, b_p, rtol=RTOL, atol=ATOL)
        e4_beta = float((b_k - b_p).abs().max())
        del p_p
        same_bits(fb_kernels.forward_e(E, u, ones), (a_k, c_k), f"K3 at {(B, N, P)}")
        same_bits(fb_kernels.backward_e(*bwd_args), (p_k, b_k), f"K4 at {(B, N, P)}")
        del p_k
        err["K3"] = max(err["K3"], e3)
        err["K4"] = max(err["K4"], e4_post, e4_beta)
        t = {
            "K3": cuda_ms(lambda: fb_kernels.forward_e(E, u, ones), 3),
            "K3_plain": k3_plain,
            "K4": cuda_ms(lambda: fb_kernels.backward_e(*bwd_args), 3),
            "K4_plain": k4_plain,
            "K3_work": bounds.k3(B, N, P), "K3_cols": N,
            "K4_work": bounds.k4(B, N, P), "K4_cols": N,
        }
        times[(B, N, P, K)] = t
        shape = f"B={B} N={N} P={P} K={K} A=16{' mixed 2/4/16' if mixed else ''}"
        print(f"  generic {shape}: ok (K3 max_abs_err {e3:.3e}; K4 posteriors "
              f"divided by their column sums max_abs_err {e4_post:.3e}, smallest "
              f"column sum {low:.3e}; K4 beta_out max_abs_err {e4_beta:.3e}); "
              f"two launches of K3 and of K4 bit-identical")
        print(f"  times {shape} [{gpu}]: K3 {t['K3']:.3f} ms, plain "
              f"{t['K3_plain']:.3f} ms; K4 {t['K4']:.3f} ms, plain "
              f"{t['K4_plain']:.3f} ms; {against_bound(t, 'K3')}; "
              f"{against_bound(t, 'K4')}", flush=True)
        del a_k, c_k, bwd_args, E
        if chunk:
            (g_k, _), gen_ms = timed(
                lambda: fb_generic.forward_backward_chunked(cols, chunk=chunk))
            walk = (B, N, -(-N // chunk))
            if fb_generic.last_walk != walk:
                raise AssertionError(f"walked {fb_generic.last_walk}, not {walk}")
            with plain_generic_kernels():
                (g_p, _), gen_plain = timed(
                    lambda: fb_generic.forward_backward_chunked(cols, chunk=chunk))
            e_route, low_route = posterior_error(g_k, g_p, f"chunked route {shape}")
            print(f"  chunked route {shape}, {walk[2]} chunks of {chunk}: kernels vs "
                  f"plain ok (posteriors divided by their column sums max_abs_err "
                  f"{e_route:.3e}, smallest column sum {low_route:.3e}); [{gpu}] "
                  f"{gen_ms:.3f} ms, plain {gen_plain:.3f} ms", flush=True)
            del g_k, g_p
        del cols
        torch.cuda.empty_cache()
    main = times[GENERIC_SHAPES[0][:4]]
    for key, target in GENERIC_TARGETS.items():
        print(f"  {key} at the SV path's shape [{gpu}]: {main[key]:.3f} ms, target "
              f"<= {target:.0f} ms: {'met' if main[key] <= target else 'missed'}")
    e3, e4 = check_padding(device)
    err["K3"], err["K4"] = max(err["K3"], e3), max(err["K4"], e4)
    return err, main


def same_bits(got, want, what: str) -> None:
    import torch

    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"{what}: a second launch gave other bits")


def check_padding(device):
    """K3/K4 against their plain versions on a batch with padding, as
    PairHMM pads chains of unequal length: chain 1 has all-zero E after
    its is_last, the padded chain all-zero E everywhere (a column without
    alleles, fb_generic.bucketed_state_emissions). Padding posteriors
    must be exactly 0 in both. Returns the largest absolute errors of K3
    (alphas, c_fwd) and K4 (divided posteriors, beta_out)."""
    import torch

    from pangenie_tpu_torch.hmm import fb_generic, fb_kernels

    B, N, P, padded, tail = PADDED_SHAPE
    cols = generic_columns(B, N, P, 32, True, seed=19, device=device)
    E = fb_generic.bucketed_state_emissions(cols).reshape(B, N, P, P)
    E[1, tail:] = 0.0
    E[padded] = 0.0
    last = cols.is_last.clone()
    last[1] = False
    last[1, tail - 1] = True
    last[padded] = False
    u = fb_generic.factor_trans(cols.trans).contiguous()
    ones = torch.ones((B, P, P), device=device)
    zeros, u_after = torch.zeros((B, P, P), device=device), torch.zeros((B, 3), device=device)
    a_k, c_k = fb_kernels.forward_e(E, u, ones)
    a_p, c_p = fb_generic.forward_e_plain(E, u, ones)
    torch.testing.assert_close(a_k, a_p, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(c_k, c_p, rtol=RTOL, atol=ATOL)
    e3 = max(float((a_k - a_p).abs().max()), float((c_k - c_p).abs().max()))
    args = (a_k, c_k, E, u, zeros, u_after, last, zeros)
    p_k, b_k = fb_kernels.backward_e(*args)
    p_p, b_p = fb_generic.backward_e_plain(*args)
    pad = torch.zeros((B, N), dtype=torch.bool, device=device)
    pad[1, tail:] = True
    pad[padded] = True
    if not (torch.equal(p_k[pad], p_p[pad]) and not p_p[pad].any()):
        raise AssertionError("K4's padding posteriors are not all 0")
    e4, low = posterior_error(p_k[~pad][None], p_p[~pad][None], "K4 with padding")
    torch.testing.assert_close(b_k, b_p, rtol=RTOL, atol=ATOL)
    e4 = max(e4, float((b_k - b_p).abs().max()))
    print(f"  padding B={B} N={N} P={P} (chain 1 padded from column {tail}, chain "
          f"{padded} all padding): ok (K3 max_abs_err {e3:.3e}; K4 real columns "
          f"divided by their sums max_abs_err {e4:.3e}, smallest column sum "
          f"{low:.3e}; padding posteriors 0 in both)", flush=True)
    return e3, e4


def check_wide(device, gpu, shapes):
    """K3/K4 past 128 paths against their plain versions at every (B, N,
    P, K) of ``shapes``, on the same inputs (K4 takes the kernel's
    alphas), with entry carries that are not ones and zeros (each chain's
    alpha0 and beta0 drawn positive), timed beside their bounds; compared
    a chain at a time, so that the comparisons' temporaries stay small
    beside a chunk that fills the card. Each shape's tier and launch are
    printed first, on the cluster tier each kernel's
    cudaOccupancyMaxActiveClusters reading, on the grid tier its CTAs a
    chain, where the band lives, the merge's hops and the CTAs the card
    holds at once. Returns the largest absolute errors and the times at
    shapes[0]."""
    import torch

    from pangenie_tpu_torch.hmm import bounds, fb_generic, fb_kernels

    err = {"K3": 0.0, "K4": 0.0}
    main = None
    g = torch.Generator(device=device)
    g.manual_seed(43)
    for B, N, P, K in shapes:
        tier = fb_kernels.tier(P, B)
        ranks, threads, smem = fb_kernels.generic_launch(P, B)
        occupancy = ""
        if tier == "cluster":
            fits = {name: fb_kernels.cluster_fits(P, B, backward)
                    for name, backward in (("K3", False), ("K4", True))}
            occupancy = (f", cudaOccupancyMaxActiveClusters K3 {fits['K3']} / K4 "
                         f"{fits['K4']} clusters of {ranks} at once")
            if min(fits.values()) < 1:
                raise AssertionError(f"no cluster of {ranks} CTAs fits the card at P={P}")
        grid = None
        if tier == "grid":
            capacity = fb_kernels.grid_capacity()
            grid = fb_kernels.grid_layout(P, B, capacity)
            occupancy = (f", the band ({grid.rows} rows at most) in "
                         f"{fb_kernels.STORES[grid.store]}, {grid.rows_per_warp} rows a warp of "
                         f"{grid.columns_per_lane} column slots a lane, merged in {grid.hops} "
                         f"hop(s); the card holds {capacity} such CTAs at once "
                         f"(cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs)")
        print(f"  B={B} N={N} P={P}: K3/K4's {tier} tier, {ranks} CTA(s) a chain of "
              f"{threads} threads and {smem} shared bytes{occupancy}", flush=True)
        cols = generic_columns(B, N, P, K, True, seed=23, device=device)
        E = fb_generic.bucketed_state_emissions(cols).reshape(B, N, P, P)
        u = fb_generic.factor_trans(cols.trans).contiguous()
        alpha0 = torch.rand((B, P, P), generator=g, device=device) + 0.5
        beta0 = torch.rand((B, P, P), generator=g, device=device) + 0.5
        beta0 /= beta0.sum(dim=(1, 2), keepdim=True)
        e_after = torch.rand((B, P, P), generator=g, device=device)
        u_after = u[:, 1].contiguous()
        last = cols.is_last.clone()
        last[:, -1] = False                    # the chunk goes on after its end
        (a_k, c_k), _ = timed(lambda: fb_kernels.forward_e(E, u, alpha0))
        (a_p, c_p), k3_plain = timed(lambda: fb_generic.forward_e_plain(E, u, alpha0))
        e3 = float((c_k - c_p).abs().max())
        torch.testing.assert_close(c_k, c_p, rtol=RTOL, atol=ATOL)
        for b in range(B):
            torch.testing.assert_close(a_k[b], a_p[b], rtol=RTOL, atol=ATOL)
            e3 = max(e3, float((a_k[b] - a_p[b]).abs().max()))
        del a_p, c_p
        args = (a_k, c_k, E, u, e_after, u_after, last, beta0)
        (p_k, b_k), _ = timed(lambda: fb_kernels.backward_e(*args))
        (p_p, b_p), k4_plain = timed(lambda: fb_generic.backward_e_plain(*args))
        e4, low = 0.0, float("inf")
        for b in range(B):
            e_b, low_b = posterior_error(p_k[b], p_p[b],
                                         f"K4 at B={B} N={N} P={P}, chain {b}")
            e4, low = max(e4, e_b), min(low, low_b)
        torch.testing.assert_close(b_k, b_p, rtol=RTOL, atol=ATOL)
        e4 = max(e4, float((b_k - b_p).abs().max()))
        del p_p
        same_bits(fb_kernels.forward_e(E, u, alpha0), (a_k, c_k), f"K3 at P={P}")
        same_bits(fb_kernels.backward_e(*args), (p_k, b_k), f"K4 at P={P}")
        err["K3"], err["K4"] = max(err["K3"], e3), max(err["K4"], e4)
        t = {"K3": cuda_ms(lambda: fb_kernels.forward_e(E, u, alpha0), 3),
             "K3_plain": k3_plain,
             "K4": cuda_ms(lambda: fb_kernels.backward_e(*args), 3), "K4_plain": k4_plain,
             "K3_work": bounds.k3(B, N, P), "K3_cols": N,
             "K4_work": bounds.k4(B, N, P), "K4_cols": N,
             "shape": f"B={B} N={N} P={P}", "tier": tier, "ranks": ranks,
             "threads": threads, "smem": smem,
             "store": fb_kernels.STORES[grid.store] if grid else None,
             "hops": grid.hops if grid else None}
        main = main or t
        shape = f"B={B} N={N} P={P} K={K} A=16 mixed 2/4/16"
        print(f"  {tier} tier {shape}, entry carries drawn: ok (K3 max_abs_err {e3:.3e}; "
              f"K4 posteriors divided by their column sums and beta_out max_abs_err "
              f"{e4:.3e}, smallest column sum {low:.3e}); two launches bit-identical")
        print(f"  times {shape} [{gpu}]: K3 {t['K3']:.3f} ms, plain {k3_plain:.3f} ms; "
              f"K4 {t['K4']:.3f} ms, plain {k4_plain:.3f} ms; {against_bound(t, 'K3')}; "
              f"{against_bound(t, 'K4')}", flush=True)
        del cols, E, u, a_k, c_k, p_k, b_k, args
        torch.cuda.empty_cache()
    return err, main


def time_routes(cols, what: str, gpu: str) -> None:
    """The fused route (emissions, K1, K2) and the generic route
    (bucketed emissions, K3/K4 in the chunks pick_chunk chooses,
    collapse) on the columns ``cols``, each the mean of 3 runs after a
    warm-up, in turns; their posteriors held against each other (divided
    by their column sums). batch.MAX_FUSED_ALLELES is not consulted:
    both routes run whatever the rule says."""
    import torch

    from pangenie_tpu_torch.hmm import fb_generic, fb_kernels
    from pangenie_tpu_torch.hmm.forward_backward import allele_emissions

    def fused():
        ea = allele_emissions(cols)
        a, c = fb_kernels.forward(ea, cols.allele_local, cols.trans)
        return fb_kernels.backward(a, c, ea, cols.allele_local, cols.trans,
                                   cols.is_last)

    def generic():
        return fb_generic.forward_backward_chunked(cols)[0]

    # the columns up to each chain's last one (a batch's chains are
    # padded) whose raw posteriors float32 keeps in the fused route (a
    # real column's may sum to 1e-50); posterior_error fails where the
    # generic route's do not sum above POST_FLOOR there
    last = cols.is_last.to(torch.int32)
    p_f, p_g = fused(), generic()
    kept = ((last.cumsum(dim=1) - last) == 0) & (p_f.sum(dim=(-2, -1)) > POST_FLOOR)
    e, low = posterior_error(p_f[kept], p_g[kept], f"fused vs generic route {what}")
    n_real = int(((last.cumsum(dim=1) - last) == 0).sum())
    del p_f, p_g
    chunks = fb_generic.last_walk[2]
    f1, g1 = cuda_ms(fused, 3), cuda_ms(generic, 3)
    g2, f2 = cuda_ms(generic, 3), cuda_ms(fused, 3)
    tier = fused_tier(cols.allele_local.shape[-1], cols.incidence.shape[-1])
    print(f"  routes {what} [{gpu}]: fused (emissions, K1, K2; {tier}) {f1:.3f} / {f2:.3f} "
          f"ms; generic (bucketed emissions, K3/K4 in {chunks} chunk(s), collapse) "
          f"{g1:.3f} / {g2:.3f} ms (in turns); the routes' posteriors divided by "
          f"their column sums agree on {int(kept.sum())} of {n_real} columns (the "
          f"others sum to {POST_FLOOR:.0e} or less in the fused route; max_abs_err {e:.3e}, "
          f"smallest sum {low:.3e})", flush=True)
    torch.cuda.empty_cache()


def check_routes(device, gpu) -> None:
    """:func:`time_routes` at every ROUTE_SHAPES entry."""
    import numpy as np
    import torch

    from pangenie_tpu_torch.hmm.forward_backward import columns_from_numpy
    from pangenie_tpu_torch.utils.synthetic import synthetic_columns

    for B, N, P, K, A in ROUTE_SHAPES:
        if A == 16:
            cols = generic_columns(B, N, P, K, True, seed=17, device=device)
            what = f"B={B} N={N} P={P} K={K} A=16 mixed 2/4/16"
        else:
            cols = columns_from_numpy(
                synthetic_columns(n_columns=N, n_paths=P, n_kmers=K, n_alleles=A,
                                  batch_dims=(B,), seed=7, dtype=np.float32),
                device, torch.float32)
            what = f"B={B} N={N} P={P} K={K} A={A}"
        time_routes(cols, what, gpu)
        del cols


def rewrite_sv_sites(variants, rng, n_alts, lengths=(100, 400)):
    """Every SV site of ``simulate_panel(sv_fraction=...)`` (an insertion
    of 100 bp or more) becomes one record with ``n_alts[0]``..``n_alts[1]``
    distinct insertion ALTs of ``lengths`` bp, each carried by at least
    one haplotype (so the HMM column has more than 8 alleles). Other
    sites are kept. Returns the number of sites rewritten."""
    import numpy as np

    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    rewritten = 0
    for v in variants:
        if len(v.alts[0]) - len(v.ref) < 100:
            continue
        n = int(rng.integers(n_alts[0], n_alts[1] + 1))
        alts = set()
        while len(alts) < n:
            size = int(rng.integers(lengths[0], lengths[1] + 1))
            alts.add(v.ref + bases[rng.integers(0, 4, size)].tobytes())
        v.alts = sorted(alts)
        haps = rng.integers(0, n + 1, 2 * len(v.genotypes))
        haps[rng.permutation(len(haps))[:n]] = np.arange(1, n + 1)
        v.genotypes = [(int(a), int(b)) for a, b in haps.reshape(-1, 2)]
        rewritten += 1
    return rewritten


def draw_genotypes(variants, samples: int, rng) -> None:
    """Each variant's phased genotypes drawn as utils/simulate.py draws
    them (allele frequencies from a Dirichlet(0.8) over its alleles, at
    least one non-reference haplotype), in one call a variant instead of
    two a sample: for panels of a thousand samples."""
    import numpy as np

    for v in variants:
        k = len(v.alts) + 1
        haps = rng.choice(k, size=(samples, 2), p=rng.dirichlet(np.ones(k) * 0.8))
        if not haps.any():
            haps[0, 0] = 1
        v.genotypes = [(int(a), int(b)) for a, b in haps]


def build_inputs(workdir: str, mb: float, chroms: int, samples: int,
                 distance: int, seed: int, sv_fraction: float = 0.0,
                 sv_alts=None, vector_genotypes: bool = False) -> str:
    """A workload made with the port's simulator (as bench.py and
    benchmarks/genome_scale.py make theirs), 12x 150 bp reads of sample
    0, cached by its parameters. With ``sv_alts`` the SV sites are
    rewritten by :func:`rewrite_sv_sites`; with ``vector_genotypes`` the
    genotypes are drawn by :func:`draw_genotypes`."""
    import numpy as np

    from pangenie_tpu_torch.utils import simulate as sim

    coverage, read_len = 12.0, 150
    tag = f"mb{mb}_c{chroms}_s{samples}_cov{coverage}_d{distance}_seed{seed}"
    if sv_alts:
        tag += f"_sv{sv_fraction}_alts{sv_alts[0]}-{sv_alts[1]}"
    if vector_genotypes:
        tag += "_vg"
    casedir = os.path.join(workdir, tag)
    if os.path.exists(os.path.join(casedir, "DONE")):
        return casedir
    os.makedirs(casedir, exist_ok=True)
    rng = np.random.default_rng(seed)
    length = int(mb / chroms * 1_000_000)
    n_var = n_sv = 0
    with open(os.path.join(casedir, "ref.fa"), "w") as fa, open(
        os.path.join(casedir, "panel.vcf"), "w"
    ) as vcf, open(os.path.join(casedir, "truth.vcf"), "w") as tr, open(
        os.path.join(casedir, "reads.fa"), "wb"
    ) as rd:
        vcf.write("##fileformat=VCFv4.2\n")
        vcf.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                  + "\t".join(f"S{i}" for i in range(samples)) + "\n")
        tr.write("##fileformat=VCFv4.2\n")
        tr.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS\n")
        for c in range(chroms):
            name = f"chr{c + 1}"
            ref = sim.random_reference(length, rng)
            variants = sim.simulate_panel(ref, nr_samples=1 if vector_genotypes else samples,
                                          rng=rng, mean_distance=distance,
                                          sv_fraction=sv_fraction)
            if vector_genotypes:
                draw_genotypes(variants, samples, rng)
            if sv_alts:
                n_sv += rewrite_sv_sites(variants, rng, sv_alts)
            n_var += len(variants)
            fa.write(f">{name}\n")
            seq = ref.decode()
            for i in range(0, len(seq), 10_000_000):
                fa.write(seq[i:i + 10_000_000] + "\n")
            for out, gts_of in (
                (vcf, lambda v: "\t".join(f"{a}|{b}" for a, b in v.genotypes)),
                (tr, lambda v: "{}/{}".format(*sorted(v.genotypes[0]))),
            ):
                out.write("".join(
                    f"{name}\t{v.position + 1}\t.\t{v.ref.decode()}\t"
                    f"{','.join(x.decode() for x in v.alts)}\t.\tPASS\t.\t"
                    f"GT\t{gts_of(v)}\n"
                    for v in variants
                ))
            # sample 0 is the genotyped individual
            h1, h2 = sim.haplotype_sequences(ref, variants, 0)
            sim.simulate_reads_to_file(h1, h2, coverage, read_len, rng, rd)
    with open(os.path.join(casedir, "DONE"), "w") as out:
        out.write(f"variants={n_var} sv_sites={n_sv}\n")
    return casedir


def timed_inputs(params: dict):
    """(casedir, seconds) of :func:`build_inputs` under smoke_inputs/."""
    t0 = time.monotonic()
    casedir = build_inputs(os.path.join(ROOT, "build", "smoke_inputs"), **params)
    return casedir, time.monotonic() - t0


def _run_single(casedir: str, outpref: str) -> float:
    """The port's ``single -g -p`` (genotyping and phasing) on CUDA;
    returns its wall in seconds."""
    import torch

    from pangenie_tpu_torch.commands import run_single_command

    t0 = time.monotonic()
    run_single_command(
        os.path.join(casedir, "reads.fa"), os.path.join(casedir, "ref.fa"),
        os.path.join(casedir, "panel.vcf"), 31, outpref,
        nr_jellyfish_threads=2, nr_core_threads=2, only_genotyping=False, device="cuda",
    )
    torch.cuda.synchronize()
    return time.monotonic() - t0


def run_e2e(casedir: str, gpu: str):
    from pangenie_tpu_torch.eval.concordance import genotype_concordance
    from pangenie_tpu_torch.hmm import batch
    from pangenie_tpu_torch.kmers import native
    from pangenie_tpu_torch.utils import timer

    outpref = os.path.join(casedir, "out")
    batches, phasing = [], {}
    reset_launches()
    with batches_kept(batches), phasing_kept(phasing):
        wall = _run_single(casedir, outpref)
    launches = launch_counts()
    if batch.last_dispatch != "cuda_fused":
        raise AssertionError(f"dispatch was {batch.last_dispatch}, not cuda_fused")
    fused = [cols for cols, route in batches if route == "cuda_fused"]
    if len(fused) != launches["K2"]:
        raise AssertionError(f"{len(fused)} fused batches but {launches['K2']} K2 launches")
    for name in ("K1", "K2", "S1", "S1_CHASE", "V1", "D1_COUNT"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the bench path")
    if not phasing["batches"] or len(phasing["batches"]) != launches["V1"]:
        raise AssertionError(f"{len(phasing['batches'])} phasing batches but "
                             f"{launches['V1']} V1 launches")
    phased = len(_vcf_body(outpref + "_phasing.vcf"))
    if phased != len(_vcf_body(outpref + "_genotyping.vcf")) or phased < 100:
        raise AssertionError(f"the phasing VCF has {phased} lines")
    if native._LIB is None:
        raise AssertionError("the native k-mer engine was not loaded")
    result = genotype_concordance(
        outpref + "_genotyping.vcf", os.path.join(casedir, "truth.vcf")
    )
    print(f"  e2e [{gpu}]: wall {wall:.2f} s, {result.total} variants, "
          f"{result.total / wall:.1f} variants/s, concordance "
          f"{result.concordance:.5f}, launches {launches}, batches (B, N, P, A) and "
          f"routes {[(batch_shape(c), r) for c, r in batches]}, phasing batches "
          f"{[batch_shape(c) for c, *_rest in phasing['batches']]} ({phased - 1} phased "
          f"variants)")
    print(f"  phase walls (s): "
          f"{json.dumps({k: round(v, 2) for k, v in timer.last_phases.items()})}",
          flush=True)
    if result.concordance < 0.99:
        raise AssertionError(f"concordance {result.concordance} < 0.99")
    return launches, fused[0], phasing


def _vcf_body(path: str) -> list:
    with open(path) as f:
        return [line for line in f if not line.startswith("##")]


def without_kmer_counts(line: str) -> str:
    """A genotyping VCF line without INFO's UK and the sample's KC. Under
    ``-p`` the reference stores the phasing run's results and combines
    the genotyping runs' likelihoods into them
    (pangenie_tpu/commands.py:632-639), so those two counts are the
    phasing run's (over its 30 paths) and may differ from ``-g``'s; the
    rest of the line may not."""
    if line.startswith("#"):
        return line
    cols = line.rstrip("\n").split("\t")
    cols[7] = ";".join(f for f in cols[7].split(";") if not f.startswith("UK="))
    keep = [i for i, key in enumerate(cols[8].split(":")) if key != "KC"]
    cols[8:] = [":".join(field.split(":")[i] for i in keep) for field in cols[8:]]
    return "\t".join(cols)


def profile_device(fn):
    """fn() under torch.profiler. Returns (wall s, device busy s, {name:
    (device s, launches)}): the busy time is the union of the device's
    kernel and copy intervals."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        dt, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (dt + (e.time_range.end - e.time_range.start) / 1e6, n + 1)
    if not spans:
        raise AssertionError("the profiled run recorded no device activity")
    busy_us, cur_start, cur_end = 0.0, None, None
    for a, b in sorted(spans):
        if cur_end is None or a > cur_end:
            if cur_end is not None:
                busy_us += cur_end - cur_start
            cur_start, cur_end = a, b
        else:
            cur_end = max(cur_end, b)
    busy_us += cur_end - cur_start
    return wall, busy_us / 1e6, by_name


def print_profile(label: str, wall: float, busy: float, by_name: dict, gpu: str) -> None:
    import torch

    from pangenie_tpu_torch.utils import timer

    print(f"  profiled {label} [{gpu}]: wall {wall:.2f} s, device busy {busy:.3f} s, "
          f"idle share {1 - busy / wall:.4f}, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; VCF bodies equal "
          f"the first run's")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    for name, (dt, n) in top:
        print(f"    device {dt:.3f} s over {n} launches: {name[:90]}")
    print(f"  phase walls (s): "
          f"{json.dumps({k: round(v, 2) for k, v in timer.last_phases.items()})}",
          flush=True)


def run_profiled(casedir: str, gpu: str) -> None:
    """The single command once more under torch.profiler: the device's
    busy time and the idle share, the rest of the traced wall."""
    import torch

    outpref = os.path.join(casedir, "out_profiled")
    torch.cuda.reset_peak_memory_stats()
    wall, busy, by_name = profile_device(lambda: _run_single(casedir, outpref))
    for kind in ("genotyping", "phasing"):
        if _vcf_body(f"{outpref}_{kind}.vcf") != _vcf_body(
            os.path.join(casedir, f"out_{kind}.vcf")
        ):
            raise AssertionError(f"the profiled run's {kind} VCF differs from the first run's")
    print_profile("e2e", wall, busy, by_name, gpu)


def run_sv_index_genotype(casedir: str, gpu: str):
    """``index`` then ``genotype -f`` on CUDA over the SV panel, then
    ``genotype -f -g -p`` (genotyping and phasing) under torch.profiler,
    whose genotyping VCF body must equal the first run's but for UK and
    KC (:func:`without_kmer_counts`). Returns the
    launch counts of the first ``index`` + ``genotype -f``, those of the
    profiled run, and its phasing (``phasing_kept``)."""
    import torch

    from pangenie_tpu_torch import commands
    from pangenie_tpu_torch.eval.concordance import genotype_concordance
    from pangenie_tpu_torch.hmm import batch, fb_generic
    from pangenie_tpu_torch.utils import timer

    prefix = os.path.join(casedir, "index")
    outpref = os.path.join(casedir, "out")

    def genotype(out, phase=False):
        commands.run_genotype_command(
            prefix, os.path.join(casedir, "reads.fa"), out,
            nr_jellyfish_threads=2, nr_core_threads=2, only_genotyping=not phase,
            device="cuda",
        )

    reset_launches()
    fb_generic.last_walk = (0, 0, 0)
    t0 = time.monotonic()
    commands.run_index_command(
        os.path.join(casedir, "ref.fa"), os.path.join(casedir, "panel.vcf"),
        31, prefix, nr_jellyfish_threads=2,
    )
    index_wall, index_phases = time.monotonic() - t0, dict(timer.last_phases)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    genotype(outpref)
    torch.cuda.synchronize()
    genotype_wall = time.monotonic() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    genotype_phases = dict(timer.last_phases)
    # one chromosome, so the HMM's one run is its only chunked walk
    walk = fb_generic.last_walk
    if batch.last_dispatch != "cuda_generic":
        raise AssertionError(f"dispatch was {batch.last_dispatch}, not cuda_generic")
    for name in ("K3", "K4", "D1_EXTRACT", "D1_COUNT"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the SV path")
    if not (walk[1] > fb_generic.SEGMENT and walk[2] > 1):
        raise AssertionError(f"the chromosome was not walked in chunks over "
                             f"{fb_generic.SEGMENT} columns: (B, N, chunks) = {walk}")
    result = genotype_concordance(
        outpref + "_genotyping.vcf", os.path.join(casedir, "truth.vcf")
    )
    with open(os.path.join(casedir, "DONE")) as f:
        made = f.read().strip()
    print(f"  sv panel ({made}) [{gpu}]: index wall {index_wall:.2f} s, "
          f"genotype -f wall {genotype_wall:.2f} s, {result.total} variants, "
          f"{result.total / genotype_wall:.1f} variants/s genotyped, concordance "
          f"{result.concordance:.5f}, chunked walk (B, N, chunks) {walk}, "
          f"launches {launches}, peak device memory {peak / 1e9:.2f} GB")
    print(f"  by class: {json.dumps(result.by_class)}")
    print(f"  index phase walls (s): "
          f"{json.dumps({k: round(v, 2) for k, v in index_phases.items()})}")
    print(f"  genotype phase walls (s): "
          f"{json.dumps({k: round(v, 2) for k, v in genotype_phases.items()})}",
          flush=True)
    if result.concordance < 0.98:
        raise AssertionError(f"concordance {result.concordance} < 0.98")

    profiled = outpref + "_profiled"
    phasing = {}
    reset_launches()
    with phasing_kept(phasing):
        wall, busy, by_name = profile_device(lambda: genotype(profiled, phase=True))
    phased_launches = launch_counts()
    with_p, without_p = (_vcf_body(f + "_genotyping.vcf") for f in (profiled, outpref))
    if list(map(without_kmer_counts, with_p)) != list(map(without_kmer_counts, without_p)):
        raise AssertionError("the profiled genotype -f -g -p genotyping VCF differs from "
                             "genotype -f's past UK and KC")
    counts_apart = sum(a != b for a, b in zip(with_p, without_p))
    phased = len(_vcf_body(profiled + "_phasing.vcf"))
    if phased != len(_vcf_body(profiled + "_genotyping.vcf")) or phased_launches["V1"] < 1:
        raise AssertionError(f"the SV phasing VCF has {phased} lines, V1 launched "
                             f"{phased_launches['V1']} times")
    print_profile("sv genotype -f -g -p", wall, busy, by_name, gpu)
    # K3/K4 are templates: the profiler names them "void fbe_forward_kernel<6, 3>(...)"
    k34 = sum(dt for name, (dt, _n) in by_name.items() if "fbe_" in name)
    v1 = sum(dt for name, (dt, _n) in by_name.items() if "v1_viterbi" in name)
    d1 = sum(dt for name, (dt, _n) in by_name.items() if "d1_" in name)
    copies = sum(dt for name, (dt, _n) in by_name.items() if "Memcpy" in name
                 or "Memset" in name)
    print(f"  sv genotype -f -g -p device time: K3+K4 {k34:.3f} s, V1 {v1:.3f} s, D1 "
          f"{d1:.3f} s, copies {copies:.3f} s, other kernels (emissions, collapse, the "
          f"table's sort, ...) {busy - k34 - v1 - d1 - copies:.3f} s of {busy:.3f} s busy; "
          f"HMM phase wall "
          f"{timer.last_phases.get('genotyping (HMM)', float('nan')):.2f} s; launches "
          f"{phased_launches}; phasing batches "
          f"{[(batch_shape(c), length) for c, _u, _s, length in phasing['batches']]} "
          f"({phased - 1} phased variants); its genotyping VCF body equal to genotype -f's "
          f"but for UK and KC, the phasing run's as the reference writes them under -p, "
          f"which differ on {counts_apart} of {len(with_p)} lines", flush=True)
    return launches, phased_launches, phasing


@contextlib.contextmanager
def patched(module, name, value):
    saved = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, saved)


@contextlib.contextmanager
def batches_kept(captured: list):
    """While it is open, every batch the genotyping driver hands to
    forward_backward_batch goes to ``captured`` as (its columns, the
    route it took)."""
    from pangenie_tpu_torch.hmm import batch, genotyping
    from pangenie_tpu_torch.parallel import genotyping as grid

    def kept(columns):
        out = batch.forward_backward_batch(columns)
        captured.append((columns, batch.last_dispatch))
        return out

    # a long run's batch, and every other batch (run_grid_local_sharded)
    with patched(genotyping, "forward_backward_batch", kept), \
            patched(grid, "forward_backward_batch", kept):
        yield


@contextlib.contextmanager
def phasing_kept(captured: dict):
    """While it is open, PairHMM's phasing goes to
    ``captured``: under "runs" each phasing PairHMM's arguments (records,
    probabilities, recombination rate, uniform, effective N, paths) in
    the order the commands make them, under "batches" each batch it
    phases as (its columns, uniform, the states it got, the length a long
    run's columns are padded to or None)."""
    from pangenie_tpu_torch.hmm import genotyping
    from pangenie_tpu_torch.parallel import genotyping as grid

    captured.update(runs=[], batches=[])
    init, phase_batch = genotyping.PairHMM.__init__, grid.viterbi
    phase_long = genotyping.viterbi_segmented

    def kept_init(self, records, probabilities, run_genotyping, run_phasing,
                  recombrate=1.26, uniform=False, effective_N=25000.0, only_paths=None, **kw):
        if run_phasing:
            captured["runs"].append(dict(
                records=records, probabilities=probabilities, recombrate=recombrate,
                uniform=uniform, effective_N=effective_N,
                paths=None if only_paths is None else list(only_paths)))
        init(self, records, probabilities, run_genotyping, run_phasing, recombrate, uniform,
             effective_N, only_paths, **kw)

    def kept_batch(columns, uniform=False, *args, **kw):
        states = phase_batch(columns, uniform, *args, **kw)
        captured["batches"].append((columns, uniform, states, None))
        return states

    def kept_long(columns, segment=None, uniform=False, length=None, *args, **kw):
        states = phase_long(columns, segment, uniform, length, *args, **kw)
        captured["batches"].append((columns, uniform, states, length))
        return states

    with patched(genotyping.PairHMM, "__init__", kept_init), \
            patched(grid, "viterbi", kept_batch), \
            patched(genotyping, "viterbi_segmented", kept_long):
        yield


def path_scores(inputs, b: int, states) -> list:
    """The score of chain b's state path in float64 from V1's inputs, a
    sum a stretch of columns ending at a column whose emissions are all
    zero (every value -inf, so it restarts uniform): each stretch sums
    the log transitions into its columns and the log emissions of those
    that are not such a column."""
    import numpy as np

    logea, al, lt = (x[b].double().cpu().numpy() if x.is_floating_point() else
                     x[b].cpu().numpy() for x in inputs)
    P = al.shape[1]
    scores, s, prev = [], 0.0, None
    for n, state in enumerate(states.tolist()):
        p1, p2 = divmod(state, P)
        if prev is not None:
            s += lt[n, int(p1 != prev[0]) + int(p2 != prev[1])]
        if not np.isfinite(logea[n]).any():
            scores.append(s)
            s = 0.0
        else:
            s += logea[n, al[n, p1], al[n, p2]]
        prev = (p1, p2)
    return scores + [s]


def check_phasing_batch(batch: tuple, label: str, plain_columns: int, gpu: str) -> dict:
    """V1 on a phasing batch a run captured (its own columns, padded as
    the run padded them): against the plain version on its first
    ``plain_columns`` columns (the same states, or where they part two
    paths that tie within V1_TIE_RTOL, rescored in float64, printed with
    the column; exit carries within V1_CARRY_ATOL where their bits
    differ), then launched on the whole batch, whose states must be the
    run's, and timed there beside its bound. Returns the times and the
    largest error."""
    import numpy as np
    import torch

    from pangenie_tpu_torch.hmm import bounds, v1_kernels, viterbi

    cols, uniform, run_states, length = batch
    inputs = viterbi.viterbi_inputs(cols, uniform, length)
    B, N, P = inputs.al.shape
    A = inputs.logea.shape[-1]
    carry = torch.zeros((B, P * P), dtype=torch.float32, device=inputs.al.device)
    first = torch.ones((B,), dtype=torch.bool, device=inputs.al.device)
    n = min(N, plain_columns)
    part = viterbi.Inputs(*(x[:, :n].contiguous() for x in inputs))
    got = v1_kernels.sweep(part, carry, first)
    want, plain_ms = timed(lambda: viterbi.segment_plain(part, carry, first))
    ties = 0
    for b in range(B):
        parted = (got.states[b] != want.states[b]).nonzero()
        if len(parted):
            ties += 1
            ours, theirs = path_scores(part, b, got.states[b]), path_scores(part, b, want.states[b])
            print(f"  V1 and the plain version part at chain {b} column {int(parted[0])}: path "
                  f"scores (float64, rescored) {ours} and {theirs}")
            np.testing.assert_allclose(ours, theirs, rtol=V1_TIE_RTOL, atol=0)
    same = torch.equal(got.carry.view(torch.int32), want.carry.view(torch.int32))
    if not same:
        torch.testing.assert_close(got.carry, want.carry, rtol=0, atol=V1_CARRY_ATOL)
    finite = torch.isfinite(want.carry)
    err = float((got.carry - want.carry)[finite].abs().max()) if bool(finite.any()) else 0.0
    del got, want, part
    whole = v1_kernels.sweep(inputs, carry, first)
    if not torch.equal(whole.states, run_states):
        raise AssertionError(f"V1 on {label} did not give the run's states")
    del whole
    t = {"V1": cuda_ms(lambda: v1_kernels.sweep(inputs, carry, first), 3), "V1_plain": plain_ms,
         "V1_work": bounds.v1(B, N, P, A), "V1_cols": N, "V1_err": err,
         "shape": f"B={B} N={N} P={P} A={A}", "plain_at": f"B={B} N={n} P={P} A={A}",
         "warps": v1_kernels.warps(P)}
    print(f"  V1 on {label} {t['shape']} [{gpu}]: states "
          f"{'equal' if not ties else f'equal but {ties} near-tie(s)'} and exit carries "
          f"{'the same bits' if same else f'within {err:.3e}'} against the plain version on "
          f"its first {n} columns (plain {plain_ms:.3f} ms); the run's states again at full "
          f"N; V1 {t['V1']:.3f} ms (a CTA of {t['warps']} warps a chain); "
          f"{against_bound(t, 'V1')}", flush=True)
    return t


def check_phasing_segments(batch: tuple, label: str, gpu: str) -> None:
    """A phasing batch through ``viterbi.viterbi`` twice: in one V1
    launch (the free memory's budget), and under a budget whose
    segments number at least SEGMENTS_AT_LEAST (the checkpointed form:
    forward launches without backtraces, then each segment again); the
    two must give the same states, and the run's."""
    import torch

    from pangenie_tpu_torch.hmm import v1_kernels, viterbi

    cols, uniform, run_states, length = batch
    B, N, P = cols.allele_local.shape
    N = max(N, length or 0)
    S = P * P
    # a budget that holds about a fifth of the columns' backtraces
    per_column, fixed = 2 * B * S, 4 * B * N + 16 * B * S + 4
    budget = (fixed + per_column * (N // (SEGMENTS_AT_LEAST + 1))
              + 4 * B * S * (SEGMENTS_AT_LEAST + 2)) * 16 // 15
    segment = viterbi.segment_columns(budget, B, N, P)
    n_segs = -(-N // segment)
    if n_segs < SEGMENTS_AT_LEAST:
        raise AssertionError(f"a budget of {budget} bytes gives {n_segs} segments")
    reset = v1_kernels.V1.launches
    one = viterbi.viterbi(cols, uniform, length)
    one_launches = v1_kernels.V1.launches - reset
    torch.cuda.synchronize()
    t0 = time.monotonic()
    seg = viterbi.viterbi(cols, uniform, length, budget=budget)
    torch.cuda.synchronize()
    seg_wall = time.monotonic() - t0
    seg_launches = v1_kernels.V1.launches - reset - one_launches
    if one_launches != 1 or seg_launches != 2 * n_segs - 1:
        raise AssertionError(f"{one_launches} and {seg_launches} V1 launches for one launch "
                             f"and {n_segs} segments")
    if not (torch.equal(one, seg) and torch.equal(one, run_states)):
        raise AssertionError(f"V1 on {label}: the segmented states differ from one launch's")
    print(f"  V1 on {label} through viterbi.viterbi [{gpu}]: one launch, and {n_segs} segments "
          f"of {segment} columns under a budget of {budget} bytes ({seg_launches} launches, "
          f"{seg_wall:.2f} s): the same states, the run's", flush=True)


def float64_phasing(runs: list, outpref: str, chroms: list) -> float:
    """The bench run's phasing runs again on the CPU in float64 (the plain
    version, on one thread: its small per-column operations run fastest
    so), their phasing VCF written from the run's graphs to
    ``<outpref>_phasing_cpu_float64.vcf``; returns its wall. Run in a
    worker process beside the SV panel's phase."""
    import torch

    from pangenie_tpu_torch.commands import _load
    from pangenie_tpu_torch.hmm.genotyping import PairHMM

    torch.set_num_threads(1)
    t0 = time.monotonic()
    hmms = [PairHMM(r["records"], r["probabilities"], False, True, r["recombrate"],
                    r["uniform"], r["effective_N"], r["paths"], dtype=torch.float64,
                    defer=True, device="cpu") for r in runs]
    PairHMM.run_deferred(hmms)
    wall = time.monotonic() - t0
    for i, (chrom, hmm) in enumerate(zip(chroms, hmms)):
        graph = _load(f"{outpref}_{chrom}_Graph.pkl")
        graph.write_phasing(outpref + "_phasing_cpu_float64.vcf", hmm.get_genotyping_result(),
                            i == 0, "sample")
    return wall


@contextlib.contextmanager
def float64_phasing_beside(phasing: dict, outpref: str):
    """:func:`float64_phasing` of the bench run's phasing runs in a spawned
    worker process while the block runs; yields a function that waits for
    it and prints how the card's phasing VCF (float32, V1) differs from
    the CPU's (no gate). The worker is stopped when the block ends."""
    import multiprocessing

    card = _vcf_body(outpref + "_phasing.vcf")
    chroms = list(dict.fromkeys(line.split("\t")[0] for line in card if not line.startswith("#")))
    if len(chroms) != len(phasing["runs"]):
        raise AssertionError(f"{len(phasing['runs'])} phasing runs for chromosomes {chroms}")
    pool = multiprocessing.get_context("spawn").Pool(1)
    try:
        job = pool.apply_async(float64_phasing, (phasing["runs"], outpref, chroms))
        pool.close()

        def compare():
            wall = job.get()
            cpu = _vcf_body(outpref + "_phasing_cpu_float64.vcf")
            differ = [(a, c) for a, c in zip(card, cpu) if a != c]
            print(f"  the bench run's phasing VCF (float32, V1) against the port's CPU float64 "
                  f"run of the same phasing runs (its wall {wall:.1f} s, beside the SV panel): "
                  f"{len(differ)} of {len(card)} lines differ"
                  + ("" if len(card) == len(cpu) else f", {len(cpu)} lines on the CPU"),
                  flush=True)
            for a, c in differ[:10]:
                print(f"    card: {a.rstrip()}\n    cpu:  {c.rstrip()}")

        yield compare
    finally:
        pool.terminate()
        pool.join()


def batch_shape(columns) -> tuple:
    """(B, N, P, A) of a batch of columns."""
    return (*columns.allele_local.shape, columns.incidence.shape[-1])


@contextlib.contextmanager
def first_group_kept(captured: dict):
    """While it is open, the first sample_group call's inputs and first
    path go to ``captured["group"]``."""
    from pangenie_tpu_torch.hmm import sampling

    sample_group = sampling.sample_group

    def first_group(costs, alleles, switch, valid, size, penalty):
        out = sample_group(costs, alleles, switch, valid, size, penalty)
        captured.setdefault("group", (costs, alleles, switch, out[:1].clone()))
        return out

    with patched(sampling, "sample_group", first_group):
        yield


@contextlib.contextmanager
def panels_kept(captured: dict, copy_records: bool):
    """While it is open, sample_panels_batched's arguments go to
    ``captured["args"]``, its chromosomes to ``captured["chromosomes"]``
    and its result to ``captured["paths"]``; with ``copy_records`` a copy
    of its records, taken before it changes them, to
    ``captured["records"]``."""
    import copy

    from pangenie_tpu_torch.hmm import sampling

    sample_panels = sampling.sample_panels_batched

    def panels(chrom_records, *args, **kwargs):
        if copy_records:
            captured["records"] = copy.deepcopy(chrom_records)
        captured["chromosomes"] = list(chrom_records)
        captured["args"] = args, kwargs
        captured["paths"] = sample_panels(chrom_records, *args, **kwargs)
        return captured["paths"]

    with patched(sampling, "sample_panels_batched", panels):
        yield


def s1_on_first_group(captured: dict):
    """S1 against the plain DP, on the card, on the first greedy iteration
    of a command's run (the inputs its first sample_group call was given,
    ``first_group_kept``): both paths must equal the command's first path
    and each other, scores too. Returns the largest absolute difference
    and the times, S1's over 3 launches after a warm-up."""
    import torch

    from pangenie_tpu_torch.hmm import bounds, sampling

    costs, alleles, switch, first = captured["group"]
    C, N, P = alleles.shape
    path_cost = sampling._gather_costs(costs, alleles)
    mask = torch.ones((C, N, P), dtype=torch.bool, device=alleles.device)
    args = (path_cost, mask, switch)
    got = sampling.viterbi_iteration(*args)
    want, plain_ms = timed(lambda: sampling.viterbi_iteration_plain(*args))
    if not (all(torch.equal(a, b) for a, b in zip(got, want)) and torch.equal(got[0], first[0])):
        raise AssertionError(f"S1 at P={P}: the first greedy path differs from the plain DP's")
    t = {"S1": cuda_ms(lambda: sampling.viterbi_iteration(*args), 3), "S1_plain": plain_ms,
         "S1_work": bounds.s1(C, N, P), "S1_cols": N, "shape": f"C={C} N={N} P={P}"}
    return paths_error(got, want), t


def check_sampled_panel(casedir: str, outname: str, captured: dict) -> str:
    """The ``sampling`` command's outputs: a panel VCF of the sampled
    haplotypes (and the reference path, where the index adds it) and one
    paths TSV per chromosome. Returns what was checked."""
    args, _kwargs = captured["args"]
    size, add_reference = args[0], args[3]
    with open(os.path.join(casedir, outname + "_panel.vcf")) as f:
        header = next(line for line in f if line.startswith("#CHROM")).split("\t")
    if len(header) - 9 != size + int(add_reference):
        raise AssertionError(f"the panel VCF has {len(header) - 9} haplotypes")
    for chrom in captured["chromosomes"]:
        if not os.path.exists(os.path.join(casedir, f"{outname}_paths_{chrom}.tsv")):
            raise AssertionError(f"sampling wrote no paths TSV for {chrom}")
    return (f"sampling wrote {size} + {int(add_reference)} haplotypes and "
            f"{len(captured['chromosomes'])} paths TSV(s)")


def timed_commands(walls: dict):
    """A runner of one command: its wall (to the device's last work) and
    phase walls go to ``walls[name]``."""
    import torch

    from pangenie_tpu_torch.utils import timer

    def command(name, fn):
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        walls[name] = (time.monotonic() - t0, dict(timer.last_phases))

    return command


def print_walls(walls: dict) -> None:
    for name, (_wall, phases) in walls.items():
        print(f"  {name} phase walls (s): "
              f"{json.dumps({k: round(v, 2) for k, v in phases.items()})}", flush=True)


def run_large_panel(casedir: str, gpu: str, device: str = "cuda"):
    """``index``, ``genotype -f`` and ``sampling -x 15`` on CUDA over the
    large panel (2049 paths, so auto-sampling runs S1 past 1024 paths,
    then K1/K2 at 16 paths). Checks: concordance >= 0.98; the first
    greedy path of ``genotype -f`` equals the plain DP's on the card for
    the same inputs (:func:`s1_on_first_group`, which also times S1
    there); ``sampling`` writes its panel VCF and paths TSVs
    (:func:`check_sampled_panel`); the same records sampled through
    sample_panels_batched with a budget that forces the checkpointed scan
    give the same paths. Then ``genotype -f -a LARGE_SUBSET`` (path
    subsets past the fused kernels: dispatch cuda_generic, K3/K4's
    cluster tier and no other; concordance >= 0.98), with the launch
    counts set to 0 just before it, then once more under torch.profiler
    (both from an emptied allocator cache: the same chunks and the same
    VCF body; the cluster tier's device time). Returns the launch counts of the three
    commands, S1's largest difference from the plain DP and times, the
    launch counts of the subset run and the (B, N, P, K) of its chunks."""
    import torch

    from pangenie_tpu_torch import commands
    from pangenie_tpu_torch.eval.concordance import genotype_concordance
    from pangenie_tpu_torch.hmm import batch, fb_generic, sampling
    from pangenie_tpu_torch.panel.sampling import reset_global_rand
    from pangenie_tpu_torch.utils import timer

    prefix = os.path.join(casedir, "index")
    reads = os.path.join(casedir, "reads.fa")
    captured, walls = {}, {}
    command = timed_commands(walls)
    reset_launches()
    command("index", lambda: commands.run_index_command(
        os.path.join(casedir, "ref.fa"), os.path.join(casedir, "panel.vcf"), 31, prefix,
        nr_jellyfish_threads=2))
    batches = []
    with first_group_kept(captured), batches_kept(batches):
        command("genotype -f", lambda: commands.run_genotype_command(
            prefix, reads, os.path.join(casedir, "out"), nr_jellyfish_threads=2,
            nr_core_threads=2, device=device))
    shapes = [(batch_shape(c), r) for c, r in batches]
    del batches
    if batch.last_dispatch != "cuda_fused":
        raise AssertionError(f"dispatch was {batch.last_dispatch}, not cuda_fused")
    with panels_kept(captured, copy_records=True):
        command("sampling -x 15", lambda: commands.run_sampling(
            prefix, reads, os.path.join(casedir, "sampled"), 2, 2, panel_size=15,
            device=device))
    launches = launch_counts()
    for name in ("K1", "K2", "S1", "S1_CHASE"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the large panel's path")
    result = genotype_concordance(os.path.join(casedir, "out_genotyping.vcf"),
                                  os.path.join(casedir, "truth.vcf"))
    err, t = s1_on_first_group(captured)
    wrote = check_sampled_panel(casedir, "sampled", captured)

    records = captured["records"]
    args, kwargs = captured["args"]
    size = args[0]
    states = [sampling._ChromState(c, r, args[1], args[2]) for c, r in records.items()]
    budget = min(sampling._group_peak([st], size) for st in states) // 2
    if sampling.plan_groups(states, size, 2 << 30, budget)[0]:
        raise AssertionError("the forced budget left a chromosome in a group")
    segments = []
    for st in states:
        source = sampling._PanelSegments(st, "cpu")
        segments.append(-(-st.N // sampling.segment_columns(
            budget, 1, st.N, st.P, source.column_bytes())))
    segmented = sampling.sample_panels_batched(records, *args[:4], {}, *args[5:],
                                               **dict(kwargs, budget=budget))
    if segmented != captured["paths"]:
        raise AssertionError("the checkpointed route sampled other paths")

    # path subsets past the fused kernels' 128: K3/K4's cluster tier, counted alone
    reset_launches()
    fb_generic.last_walk = (0, 0, 0)
    subsets = f"genotype -f -a {LARGE_SUBSET}"
    chunks = []
    pick_chunk = fb_generic.pick_chunk

    def chunk_kept(*args):
        chunks.append(pick_chunk(*args))
        return chunks[-1]

    def genotype_subsets(out):
        # the subsets are drawn from the process-wide rand() stream: the
        # same stream state gives the profiled rerun the same subsets; and
        # K3/K4's chunk is sized from the card's free memory
        # (fb_generic.pick_chunk), so both runs start from an emptied cache
        # and take the same chunks, whose boundaries float32 results follow
        reset_global_rand()
        torch.cuda.empty_cache()
        commands.run_genotype_command(
            prefix, reads, os.path.join(casedir, out), nr_jellyfish_threads=2,
            nr_core_threads=2, sampling_size=LARGE_SUBSET, device=device)

    with patched(fb_generic, "pick_chunk", chunk_kept):
        command(subsets, lambda: genotype_subsets("out_subsets"))
    subset_launches = launch_counts()
    walk = fb_generic.last_walk
    if len(chunks) != 1:
        raise AssertionError(f"{subsets}: {len(chunks)} chunked walks, not 1")
    # the shape each K3/K4 launch but the last of each pass took
    subset_shape = (walk[0], min(chunks[0], walk[1]), LARGE_SUBSET, 32)
    if batch.last_dispatch != "cuda_generic":
        raise AssertionError(f"{subsets}: dispatch was {batch.last_dispatch}, "
                             f"not cuda_generic")
    for name in ("K3", "K4"):
        if subset_launches[f"{name} cluster"] <= 0 or subset_launches[f"{name} grid"]:
            raise AssertionError(f"{subsets} did not take {name}'s cluster tier alone: "
                                 f"{subset_launches}")
    subset_result = genotype_concordance(os.path.join(casedir, "out_subsets_genotyping.vcf"),
                                         os.path.join(casedir, "truth.vcf"))

    with open(os.path.join(casedir, "DONE")) as f:
        made = f.read().strip()
    print(f"  large panel ({made}, {t['shape']}) [{gpu}]: "
          + ", ".join(f"{name} wall {wall:.2f} s" for name, (wall, _p) in walls.items())
          + f"; concordance {result.concordance:.5f} over {result.total} variants; first "
          f"greedy path equals the plain DP's (max_abs_err {err}); S1 on its inputs "
          f"{t['S1']:.3f} ms, plain {t['S1_plain']:.3f} ms, {against_bound(t, 'S1')}; "
          f"{wrote}; the checkpointed route (budget {budget} bytes, segments {segments}) "
          f"sampled the same paths; launches {launches}")
    print(f"  genotype -f batches (B, N, P, A) and routes: {shapes}")
    print(f"  {subsets} [{gpu}]: wall {walls[subsets][0]:.2f} s, dispatch "
          f"{batch.last_dispatch} over (B, N, chunks) {walk} in chunks of "
          f"{chunks[0]} (K3/K4's cluster tier at P={LARGE_SUBSET}), concordance "
          f"{subset_result.concordance:.5f} over {subset_result.total} variants, "
          f"launches {subset_launches}")
    print_walls(walls)
    if result.concordance < 0.98:
        raise AssertionError(f"concordance {result.concordance} < 0.98")
    if subset_result.concordance < 0.98:
        raise AssertionError(f"{subsets}: concordance {subset_result.concordance} < 0.98")

    with patched(fb_generic, "pick_chunk", chunk_kept):
        wall, busy, by_name = profile_device(lambda: genotype_subsets("out_subsets_profiled"))
    if chunks[1:] != chunks[:1]:
        raise AssertionError(f"the profiled {subsets} took chunks of {chunks[1:]}, the first "
                             f"run {chunks[0]}")
    if _vcf_body(os.path.join(casedir, "out_subsets_profiled_genotyping.vcf")) != _vcf_body(
            os.path.join(casedir, "out_subsets_genotyping.vcf")):
        raise AssertionError(f"the profiled {subsets} VCF differs from the first run's")
    print_profile(subsets, wall, busy, by_name, gpu)
    tier = {k: sum(dt for name, (dt, _n) in by_name.items() if f"fbe_{k}_cluster" in name)
            for k in ("forward", "backward")}
    print(f"  {subsets} device time: K3's cluster tier {tier['forward']:.3f} s, K4's "
          f"{tier['backward']:.3f} s of {busy:.3f} s busy; HMM phase wall "
          f"{timer.last_phases.get('genotyping (HMM)', float('nan')):.2f} s", flush=True)
    return launches, err, t, subset_launches, subset_shape


def run_widest_panel(casedir: str, gpu: str, device: str = "cuda"):
    """``index`` and ``sampling -x 15`` on CUDA over the widest panel
    (6405 paths: S1's sweep as a cluster of 8 CTAs of 7 warps a
    chromosome). Checks: the first greedy path equals the plain DP's on the
    card for the same inputs (:func:`s1_on_first_group`, which also times
    S1 there); ``sampling`` writes its panel VCF and paths TSVs
    (:func:`check_sampled_panel`). Returns the launch counts of the two
    commands, and S1's largest difference from the plain DP and times."""
    from pangenie_tpu_torch import commands

    prefix = os.path.join(casedir, "index")
    captured, walls = {}, {}
    command = timed_commands(walls)
    reset_launches()
    command("index", lambda: commands.run_index_command(
        os.path.join(casedir, "ref.fa"), os.path.join(casedir, "panel.vcf"), 31, prefix,
        nr_jellyfish_threads=2))
    with first_group_kept(captured), panels_kept(captured, copy_records=False):
        command("sampling -x 15", lambda: commands.run_sampling(
            prefix, os.path.join(casedir, "reads.fa"), os.path.join(casedir, "sampled"), 2, 2,
            panel_size=15, device=device))
    launches = launch_counts()
    for name in ("S1", "S1_CHASE"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the widest panel's path")
    err, t = s1_on_first_group(captured)
    wrote = check_sampled_panel(casedir, "sampled", captured)
    with open(os.path.join(casedir, "DONE")) as f:
        made = f.read().strip()
    print(f"  widest panel ({made}, {t['shape']}) [{gpu}]: "
          + ", ".join(f"{name} wall {wall:.2f} s" for name, (wall, _p) in walls.items())
          + f"; first greedy path equals the plain DP's (max_abs_err {err}); S1 on its "
          f"inputs {t['S1']:.3f} ms, plain {t['S1_plain']:.3f} ms, "
          f"{against_bound(t, 'S1')}; {wrote}; launches {launches}")
    print_walls(walls)
    return launches, err, t


def run_wide_subsets(casedir: str, gpu: str, device: str = "cuda"):
    """``index`` and ``genotype -f -a WIDE_SUBSET`` on CUDA over the
    wide-subsets panel (601 paths in two subsets of 600, past what a
    cluster of CTAs holds: dispatch cuda_generic, K3/K4's grid tier and
    no other; concordance >= 0.98), the launch counts set to 0 just
    before ``genotype``. Returns its launch counts and the (B, N, P, K)
    of its chunks."""
    from pangenie_tpu_torch import commands
    from pangenie_tpu_torch.eval.concordance import genotype_concordance
    from pangenie_tpu_torch.hmm import batch, fb_generic
    from pangenie_tpu_torch.panel.sampling import reset_global_rand

    prefix = os.path.join(casedir, "index")
    walls = {}
    command = timed_commands(walls)
    command("index", lambda: commands.run_index_command(
        os.path.join(casedir, "ref.fa"), os.path.join(casedir, "panel.vcf"), 31, prefix,
        nr_jellyfish_threads=2))
    subsets = f"genotype -f -a {WIDE_SUBSET}"
    chunks = []
    pick_chunk = fb_generic.pick_chunk

    def chunk_kept(*args):
        chunks.append(pick_chunk(*args))
        return chunks[-1]

    reset_launches()
    fb_generic.last_walk = (0, 0, 0)
    reset_global_rand()
    with patched(fb_generic, "pick_chunk", chunk_kept):
        command(subsets, lambda: commands.run_genotype_command(
            prefix, os.path.join(casedir, "reads.fa"), os.path.join(casedir, "out"),
            nr_jellyfish_threads=2, nr_core_threads=2, sampling_size=WIDE_SUBSET,
            device=device))
    launches = launch_counts()
    walk = fb_generic.last_walk
    if batch.last_dispatch != "cuda_generic":
        raise AssertionError(f"{subsets}: dispatch was {batch.last_dispatch}")
    for name in ("K3", "K4"):
        if (launches[f"{name} grid"] <= 0 or launches[f"{name} cluster"]
                or launches[f"{name} register"]):
            raise AssertionError(f"{subsets} did not take {name}'s grid tier alone: "
                                 f"{launches}")
    result = genotype_concordance(os.path.join(casedir, "out_genotyping.vcf"),
                                  os.path.join(casedir, "truth.vcf"))
    with open(os.path.join(casedir, "DONE")) as f:
        made = f.read().strip()
    print(f"  wide-subsets panel ({made}) [{gpu}]: "
          + ", ".join(f"{name} wall {wall:.2f} s" for name, (wall, _p) in walls.items())
          + f"; dispatch {batch.last_dispatch} over (B, N, chunks) {walk} in chunks of "
          f"{chunks[0]} (K3/K4's grid tier at P={WIDE_SUBSET}), concordance "
          f"{result.concordance:.5f} over {result.total} variants, launches {launches}",
          flush=True)
    print_walls(walls)
    if result.concordance < 0.98:
        raise AssertionError(f"{subsets}: concordance {result.concordance} < 0.98")
    return launches, (walk[0], min(chunks[0], walk[1]), WIDE_SUBSET, 32)


def d1_slice(reads: str, n_reads: int) -> str:
    """The first ``n_reads`` records of the FASTA ``reads`` as a file of
    their own beside it (made once)."""
    out = f"{reads}.first{n_reads}.fa"
    if not os.path.exists(out):
        with open(reads) as src, open(out + ".tmp", "w") as dst:
            seen = 0
            for line in src:
                if line.startswith(">"):
                    seen += 1
                    if seen > n_reads:
                        break
                dst.write(line)
        os.replace(out + ".tmp", out)
    return out


def hold_d1(reads: str, segments: str, keys, label: str, gpu: str) -> dict:
    """D1 on the first D1_SLICE_READS reads of ``reads`` as one block
    (within the main path's block at the default -e) against its plain versions
    and the host engine: the table (``keys``, or None: built on the card
    from ``segments`` and held equal to the host's key set), D1-extract's
    keys and D1-count's counts on the block equal to the plain versions'
    and to the host engine's counts of the same reads. Times both kernels beside their bounds, their plain
    versions and, for D1-count, the library calls that compute its
    function (torch.searchsorted, then torch.bincount); with ``keys``
    None, D1-extract also on the corpus's first round, as the table
    build launches it. Returns the times."""
    import numpy as np
    import torch

    from pangenie_tpu_torch.hmm import bounds
    from pangenie_tpu_torch.kmers import device_counter as dc
    from pangenie_tpu_torch.kmers.counter import ExactKmerCounter, iter_sequences

    dev, k = torch.device("cuda", 0), 31
    host_keys = keys
    if keys is None:
        host_keys = ExactKmerCounter.count_file(segments, k, n_threads=8).keys
    counter = dc.PrimedDeviceCounter(k, keys, corpus_files=[segments], device=dev)
    table = counter.table
    if not np.array_equal(table.keys.cpu().numpy().view(np.uint64), host_keys):
        raise AssertionError(f"{label}: D1's table differs from the host's key set")
    sliced = d1_slice(reads, D1_SLICE_READS)
    data, offsets = dc._joined(list(iter_sequences(sliced)))
    words, vwords, n_bases = dc.pack_sequences(data, offsets[:-1], np.diff(offsets))
    if n_bases > D1_BLOCK_BASES:
        raise AssertionError(f"{label}: the slice's {n_bases} bases exceed a block")
    words, vwords = dc._on(dev, words), dc._on(dev, vwords)
    t = {"shape": f"T={n_bases} bases, n={len(host_keys)} keys, k={k}, d={table.bits}",
         "d": table.bits}
    if table.bits != dc.directory_bits(len(host_keys), k):
        raise AssertionError(f"{label}: the table's directory is not the rule's")
    (keys_got, t["D1_EXTRACT"]) = timed(lambda: dc.extract(words, vwords, n_bases, k))
    keys_want, t["D1_EXTRACT_plain"] = timed(lambda: dc.extract_plain(words, vwords, n_bases, k))
    if not torch.equal(keys_got, keys_want):
        raise AssertionError(f"{label}: D1-extract's keys differ from the plain version's")
    got = torch.zeros(table.keys.shape, dtype=torch.int32, device=dev)
    want = torch.zeros_like(got)
    _, t["D1_COUNT_first"] = timed(lambda: dc.count(words, vwords, n_bases, k, table, got))
    _, t["D1_COUNT_plain"] = timed(
        lambda: dc.count_plain(words, vwords, n_bases, k, table, want))
    if not torch.equal(got, want):
        raise AssertionError(f"{label}: D1-count's counts differ from the plain version's")
    host = ExactKmerCounter.count_file_primed(sliced, [segments], k, n_threads=8, keys=host_keys)
    if not np.array_equal(got.cpu().numpy(), host.counts):
        raise AssertionError(f"{label}: D1's counts on the slice differ from the host engine's")
    t["D1_EXTRACT"] = cuda_ms(lambda: dc.extract(words, vwords, n_bases, k), 5)
    t["D1_COUNT"] = cuda_ms(lambda: dc.count(words, vwords, n_bases, k, table, got), 5)
    queries = keys_want[keys_want != dc.SENTINEL]
    n = len(host_keys)

    def library():
        idx = torch.searchsorted(table.keys, queries).clamp_(max=n - 1)
        return torch.bincount(idx[table.keys[idx] == queries], minlength=n)

    if not torch.equal(library().to(torch.int32), want):
        raise AssertionError(f"{label}: the library calls' counts differ from D1-count's")
    t["D1_COUNT_library"] = cuda_ms(library, 5)
    steps = dc.search_steps(table, keys_want)
    t["D1_EXTRACT_work"] = bounds.d1_extract(n_bases)
    t["D1_COUNT_work"] = bounds.d1_count(n_bases, n, steps)
    t["D1_EXTRACT_cols"] = t["D1_COUNT_cols"] = n_bases
    t["valid_windows"] = len(queries)
    t["table_reads"] = steps
    t["hits"] = int(want.sum())
    print(f"  {label} [{gpu}]: slice of {D1_SLICE_READS} reads, {t['shape']}, "
          f"{len(queries)} valid windows, {t['hits']} counted, {steps} table reads (the "
          f"directory at d={table.bits}); D1-extract {t['D1_EXTRACT']:.3f} "
          f"ms (plain {t['D1_EXTRACT_plain']:.3f}), D1-count {t['D1_COUNT']:.3f} ms (first "
          f"launch {t['D1_COUNT_first']:.3f}, plain {t['D1_COUNT_plain']:.3f}, "
          f"torch.searchsorted + torch.bincount {t['D1_COUNT_library']:.3f}), "
          f"{t['D1_COUNT'] * 1e3 / (n_bases / 1e6):.1f} us per million windows; "
          f"{against_bound(t, 'D1_EXTRACT')}; {against_bound(t, 'D1_COUNT')}; keys, counts "
          f"and the host engine's counts equal", flush=True)
    if keys is None:
        words, vwords, n_corpus = next(dc.packed_blocks([segments], k, dc.round_windows(dev)))
        words, vwords = dc._on(dev, words), dc._on(dev, vwords)
        corpus_keys = dc.extract(words, vwords, n_corpus, k)
        if not torch.equal(corpus_keys, dc.extract_plain(words, vwords, n_corpus, k)):
            raise AssertionError(f"{label}: D1-extract differs from the plain version on "
                                 f"the corpus")
        t["corpus"] = {
            "shape": f"T={n_corpus} bases (the corpus's first round)",
            "ms": cuda_ms(lambda: dc.extract(words, vwords, n_corpus, k), 5),
            "plain_ms": timed(lambda: dc.extract_plain(words, vwords, n_corpus, k))[1],
            "work": bounds.d1_extract(n_corpus), "cols": n_corpus}
        c = t["corpus"]
        print(f"  {label}: D1-extract on {c['shape']}: {c['ms']:.3f} ms (plain "
              f"{c['plain_ms']:.3f}), bound {c['work'].bound()[0]:.4f} ms by "
              f"{c['work'].bound()[1]}", flush=True)
    # kept on the host for the multi-GPU phase: the table, the block's
    # valid keys and D1-count's counts of them
    t["table_keys"] = table.keys.cpu().numpy()
    t["valid_keys"] = queries.cpu().numpy()
    t["counts"] = want.cpu().numpy()
    del counter, table, got, want, keys_got, keys_want, queries
    torch.cuda.empty_cache()
    return t


# -- multi-GPU (M1): ranks of torch.distributed on the one card ------------


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_ranks(job: str, world: int, args: dict, timeout: float) -> list:
    """Run RANK_JOBS[job](args) in ``world`` processes of this script
    joined in one process group (the variables the port reads, a TCP
    store on localhost); returns each rank's result, in rank order. Every
    process is stopped before this returns; a rank that fails, or a run
    past ``timeout`` seconds, raises with the end of its log."""
    logdir = os.path.join(ROOT, "build", "smoke_ranks", job)
    os.makedirs(logdir, exist_ok=True)
    port = _free_port()
    procs = []
    try:
        for rank in range(world):
            env = dict(os.environ, PANGENIE_TPU_COORDINATOR=f"localhost:{port}",
                       PANGENIE_TPU_NUM_PROCESSES=str(world), PANGENIE_TPU_PROCESS_ID=str(rank))
            env.pop("PANGENIE_TORCH_DEVICE", None)
            out, log = (os.path.join(logdir, f"rank{rank}.{ext}") for ext in ("json", "log"))
            if os.path.exists(out):
                os.remove(out)
            with open(log, "w") as log_file:
                procs.append((subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), "--rank-job", job,
                     json.dumps(args), out], env=env, cwd=ROOT, stdout=log_file,
                    stderr=subprocess.STDOUT), out, log))
        deadline = time.monotonic() + timeout
        results = []
        for proc, out, log in procs:
            try:
                proc.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                raise AssertionError(f"{job}: rank {len(results)} ran past {timeout} s: "
                                     f"{_tail(log)}")
            if proc.returncode != 0:
                raise AssertionError(f"{job}: rank {len(results)} exited with "
                                     f"{proc.returncode}: {_tail(log)}")
            with open(out) as f:
                results.append(json.load(f))
        return results
    finally:
        for proc, _, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def _tail(log: str) -> str:
    with open(log) as f:
        return f.read()[-3000:]


def rank_job(job: str, args: dict, out: str) -> int:
    """One rank of :func:`spawn_ranks`: join the group, run the job,
    write its result (with the rank, the world, the backend and the
    device) to ``out``."""
    from pangenie_tpu_torch.device import resolve_device
    from pangenie_tpu_torch.parallel import distributed as dist

    dist.maybe_initialize()
    result = dict(rank=dist.process_index(), world=dist.process_count(),
                  backend=dist.layout().backend, device=str(resolve_device()))
    result.update(RANK_JOBS[job](args))
    dist.shutdown()
    with open(out, "w") as f:
        json.dump(result, f)
    return 0


def _timed_launches(fn):
    """(fn(), its wall in seconds, the launches it made), the counts set
    to 0 just before it and read just after."""
    import torch

    reset_launches()
    t0 = time.monotonic()
    out = fn()
    torch.cuda.synchronize()
    return out, time.monotonic() - t0, launch_counts()


def job_world_one(args: dict) -> dict:
    """World 1 over NCCL: the partitioned counter on a block of reads
    (the whole table one partition), then dryrun_multigpu(1)."""
    import numpy as np

    from pangenie_tpu_torch.kmers import device_counter as dc
    from pangenie_tpu_torch.parallel.dryrun import dryrun_multigpu

    keys = np.load(args["keys"])
    counter, wall, launches = _timed_launches(lambda: dc.count_file_primed_sharded(
        args["reads"], 31, keys, block_bases=D1_BLOCK_BASES))
    np.save(args["counts_out"], counter.counts)
    dry, dry_wall, dry_launches = _timed_launches(lambda: dryrun_multigpu(1))
    return dict(counter_wall=wall, counter_launches=launches, dryrun=dry,
                dryrun_wall=dry_wall, dryrun_launches=dry_launches)


def job_pair(args: dict) -> dict:
    """Two ranks sharing the card: the bench ``single -g -p`` through the
    CLI; the partitioned counter over the SV table built on the card (a
    partition a rank) on a block of the SV reads; then the SV ``genotype
    -f`` through the CLI with ``table_fits`` refusing the whole table and
    taking a half, so that ``_read_counter`` takes its partitioned route,
    whose counts are kept."""
    import numpy as np

    from pangenie_tpu_torch import cli
    from pangenie_tpu_torch.kmers import device_counter as dc
    from pangenie_tpu_torch.parallel import distributed as dist

    rc, wall, launches = _timed_launches(lambda: cli.main([
        "genotype", "-i", args["reads"], "-r", args["ref"], "-v", args["panel"], "-o",
        args["out"], "-j", "2", "-t", "2", "-g", "-p"]))
    if rc != 0:
        raise AssertionError(f"single exited with {rc}")
    counter, sv_wall, sv_launches = _timed_launches(lambda: dc.count_file_primed_sharded(
        args["sv_reads"], 31, None, block_bases=D1_BLOCK_BASES,
        corpus_files=[args["sv_segments"]]))
    if dist.is_coordinator():
        np.save(args["sv_counts_out"], counter.counts)
        np.save(args["sv_keys_out"], counter.keys)

    # the corpus's size bounds the table _read_counter sizes (no keys
    # under -f): the whole refused, a half taken
    half = -(-os.path.getsize(args["sv_segments"]) // 2)
    sharded, taken = dc.count_file_primed_sharded, []

    def kept(*a, **kw):
        taken.append(sharded(*a, **kw))
        return taken[-1]

    with patched(dc, "table_fits", lambda n, device, block: n <= half), \
            patched(dc, "count_file_primed_sharded", kept):
        rc, gf_wall, gf_launches = _timed_launches(lambda: cli.main([
            "genotype", "-i", args["sv_reads_all"], "-f", args["sv_prefix"], "-o",
            args["sv_out"], "-j", "2", "-t", "2", "-g"]))
    if rc != 0 or len(taken) != 1:
        raise AssertionError(f"genotype -f exited with {rc}, the partitioned counter taken "
                             f"{len(taken)} times")
    if dist.is_coordinator():
        np.save(args["gf_counts_out"], taken[0].counts)
        np.save(args["gf_keys_out"], taken[0].keys)
    return dict(single_wall=wall, single_launches=launches, sv_wall=sv_wall,
                sv_launches=sv_launches, gf_wall=gf_wall, gf_launches=gf_launches)


RANK_JOBS = {"world_one": job_world_one, "pair": job_pair}


def run_multigpu(casedir: str, sv_dir: str, d1_bench: dict, d1_sv: dict, gpu: str) -> dict:
    """(a) world 1 over NCCL and (b) two ranks sharing the card over gloo
    (:func:`spawn_ranks`), checked against the one-process runs; returns
    the launches of D1-count-keys on these paths and the walls."""
    import numpy as np

    work = os.path.join(ROOT, "build", "smoke_ranks")
    os.makedirs(work, exist_ok=True)
    bench_segments = os.path.join(casedir, "out_path_segments.fasta")
    keys_path = os.path.join(work, "bench_keys.npy")
    np.save(keys_path, d1_bench["table_keys"].view(np.uint64))
    counts_out = os.path.join(work, "world_one_counts.npy")
    t0 = time.monotonic()
    (one,) = spawn_ranks("world_one", 1, dict(
        reads=d1_slice(os.path.join(casedir, "reads.fa"), D1_SLICE_READS), keys=keys_path,
        counts_out=counts_out), timeout=300)
    wall_a = time.monotonic() - t0
    if (one["backend"], one["device"]) != ("nccl", "cuda:0"):
        raise AssertionError(f"world 1 ran on {one['backend']} / {one['device']}")
    if not np.array_equal(np.load(counts_out), d1_bench["counts"]):
        raise AssertionError("the partitioned counter's counts differ from D1-count's")
    for what, launches, names in (
            ("partitioned counter", one["counter_launches"], ("D1_EXTRACT", "D1_COUNT_KEYS")),
            ("dryrun_multigpu(1)", one["dryrun_launches"], ("K1", "K2", "S1", "D1_COUNT_KEYS"))):
        for name in names:
            if launches[name] <= 0:
                raise AssertionError(f"world 1: {name} was not launched by the {what}")
    print(f"  (a) world 1 over NCCL on {one['device']} [{gpu}]: the partitioned counter on "
          f"the bench block {one['counter_wall']:.2f} s, counts equal D1-count's; "
          f"dryrun_multigpu(1) {one['dryrun_wall']:.2f} s ({one['dryrun']}); launches "
          f"{one['counter_launches']} / {one['dryrun_launches']}; the process {wall_a:.1f} s",
          flush=True)

    out, sv_out = os.path.join(casedir, "ranks2"), os.path.join(sv_dir, "ranks2")
    sv_counts, sv_keys, gf_counts, gf_keys = (
        os.path.join(work, f"pair_{x}.npy") for x in ("sv_counts", "sv_keys", "gf_counts",
                                                       "gf_keys"))
    sv_reads_all = os.path.join(sv_dir, "reads.fa")
    sv_segments = os.path.join(sv_dir, "index_path_segments.fasta")
    t0 = time.monotonic()
    pair = spawn_ranks("pair", 2, dict(
        reads=os.path.join(casedir, "reads.fa"), ref=os.path.join(casedir, "ref.fa"),
        panel=os.path.join(casedir, "panel.vcf"), out=out,
        sv_reads=d1_slice(sv_reads_all, D1_SLICE_READS), sv_segments=sv_segments,
        sv_counts_out=sv_counts, sv_keys_out=sv_keys, sv_reads_all=sv_reads_all,
        sv_prefix=os.path.join(sv_dir, "index"), sv_out=sv_out, gf_counts_out=gf_counts,
        gf_keys_out=gf_keys), timeout=540)
    wall_b = time.monotonic() - t0
    for r in pair:
        if (r["backend"], r["device"]) != ("gloo", "cuda:0"):
            raise AssertionError(f"rank {r['rank']} ran on {r['backend']} / {r['device']}")
        for name in ("D1_COUNT", "S1"):
            if r["single_launches"][name] <= 0:
                raise AssertionError(f"rank {r['rank']}: {name} was not launched by single")
        for name in ("D1_EXTRACT", "D1_COUNT_KEYS"):
            if r["sv_launches"][name] <= 0 or r["gf_launches"][name] <= 0:
                raise AssertionError(f"rank {r['rank']}: {name} was not launched by the SV "
                                     f"partitioned counter or by genotype -f")
    for name in ("K1", "K2", "V1"):
        if sum(r["single_launches"][name] for r in pair) <= 0:
            raise AssertionError(f"no rank launched {name} in single")
    for name in ("K3", "K4"):
        if sum(r["gf_launches"][name] for r in pair) <= 0:
            raise AssertionError(f"no rank launched {name} in the SV genotype -f")
    for kind in ("genotyping", "phasing"):
        if _vcf_body(f"{out}_{kind}.vcf") != _vcf_body(os.path.join(casedir, f"out_{kind}.vcf")):
            raise AssertionError(f"two ranks' {kind} VCF differs from the one-process run's")
    if not (np.array_equal(np.load(sv_keys), d1_sv["table_keys"].view(np.uint64))
            and np.array_equal(np.load(sv_counts), d1_sv["counts"])):
        raise AssertionError("the SV partitioned counter's counts differ from D1-count's")
    if _vcf_body(f"{sv_out}_genotyping.vcf") != _vcf_body(
            os.path.join(sv_dir, "out_genotyping.vcf")):
        raise AssertionError("two ranks' SV genotype -f VCF differs from the one-process run's")
    # the one-process D1 count of every SV read, the table built on the card
    import torch

    from pangenie_tpu_torch.kmers import device_counter as dc

    whole = dc.count_file_primed_device(sv_reads_all, [sv_segments], 31,
                                        block_bases=D1_BLOCK_BASES, device="cuda")
    if not (np.array_equal(np.load(gf_keys), whole.keys)
            and np.array_equal(np.load(gf_counts), whole.counts)):
        raise AssertionError("genotype -f's partitioned counts differ from one process's D1")
    n_keys = len(whole.keys)
    del whole
    torch.cuda.empty_cache()
    for r in pair:
        print(f"  (b) rank {r['rank']} of 2 over {r['backend']} on {r['device']} [{gpu}]: "
              f"single -g -p {r['single_wall']:.2f} s, launches {r['single_launches']}; the "
              f"SV table partitioned {r['sv_wall']:.2f} s, launches {r['sv_launches']}; SV "
              f"genotype -f, the partitioned route, {r['gf_wall']:.2f} s, launches "
              f"{r['gf_launches']}", flush=True)
    print(f"  (b) two ranks' genotyping and phasing VCF bodies equal the one-process run's, "
          f"the SV block's counts phase 6's, the SV genotype -f VCF body the one-process "
          f"run's and its counts of {n_keys} keys one process's D1 count of every SV read; "
          f"both processes {wall_b:.1f} s", flush=True)
    return dict(
        # the command path alone: _read_counter's partitioned route
        launches=sum(r["gf_launches"]["D1_COUNT_KEYS"] for r in pair),
        check_launches={"world 1 over NCCL: the partitioned counter, bench block":
                        one["counter_launches"]["D1_COUNT_KEYS"],
                        "world 1 over NCCL: dryrun_multigpu(1)":
                        one["dryrun_launches"]["D1_COUNT_KEYS"],
                        "two ranks over gloo: the SV block partitioned":
                        sum(r["sv_launches"]["D1_COUNT_KEYS"] for r in pair)},
        walls=dict(world_one_process=wall_a, pair_processes=wall_b,
                   world_one_counter=one["counter_wall"], world_one_dryrun=one["dryrun_wall"],
                   pair_single=[r["single_wall"] for r in pair],
                   pair_sv=[r["sv_wall"] for r in pair],
                   pair_sv_genotype=[r["gf_wall"] for r in pair]))


def check_grid_over_cards(fused_cpu, phasing_cpu, gpu: str) -> None:
    """(c) run_grid_local_sharded with [cuda:0, cuda:0] on the bench run's
    own fused and phasing batches: the single call's results bit for
    bit, a launch of K1, K2 (V1) for each device's block."""
    import numpy as np
    import torch

    from pangenie_tpu_torch.hmm.batch import forward_backward_batch
    from pangenie_tpu_torch.hmm.forward_backward import ColumnArrays
    from pangenie_tpu_torch.hmm.viterbi import viterbi
    from pangenie_tpu_torch.parallel.genotyping import run_grid_local_sharded

    dev = torch.device("cuda", 0)
    for what, cpu_cols, uniform in (("fused", fused_cpu, False),
                                    ("phasing", phasing_cpu[0], phasing_cpu[1])):
        cols = ColumnArrays(*[x.to(dev) for x in cpu_cols])
        B = cols.lp.shape[0]
        members = [ColumnArrays(*[x[i] for x in cols]) for i in range(B)]
        run_g = what == "fused"
        (posts, corr, states), wall, launches = _timed_launches(
            lambda: run_grid_local_sharded(members, run_g, not run_g, uniform, [dev, dev]))
        if run_g:
            want_posts, want_corr = forward_backward_batch(cols)
            same = (np.array_equal(posts, want_posts.cpu().numpy())
                    and np.array_equal(corr, want_corr.cpu().numpy()))
            kernels_of = ("K1", "K2")
        else:
            same = np.array_equal(states, viterbi(cols, uniform).cpu().numpy())
            kernels_of = ("V1",)
        if not same:
            raise AssertionError(f"(c) the {what} batch over [cuda:0, cuda:0] differs from "
                                 f"the single call")
        n_use = min(2, B)
        if any(launches[k] != n_use for k in kernels_of):
            raise AssertionError(f"(c) {launches} for {n_use} device blocks")
        print(f"  (c) the bench run's {what} batch {batch_shape(cols)} over [cuda:0, cuda:0] "
              f"[{gpu}]: bit-identical to the single call, {wall * 1e3:.1f} ms, launches "
              f"{ {k: launches[k] for k in kernels_of} }", flush=True)


def check_count_keys(d1_sv: dict, gpu: str) -> dict:
    """(d) D1-count-keys on the SV block's valid keys, routed by their
    owner into 2 and 4 partitions of the SV table on the one card: every
    partition's counts equal the plain version's and D1-count's counts
    of its keys; partition 0 timed beside its bound, its plain version
    and torch.searchsorted then torch.bincount, and the routing (owner,
    sort by owner, the sizes) timed. Returns the times by partitions."""
    import torch

    from pangenie_tpu_torch.hmm import bounds
    from pangenie_tpu_torch.kmers import device_counter as dc

    dev = torch.device("cuda", 0)
    keys = torch.from_numpy(d1_sv["valid_keys"]).to(dev)
    table_keys = torch.from_numpy(d1_sv["table_keys"]).to(dev)
    whole = torch.from_numpy(d1_sv["counts"]).to(dev)
    out = {}
    for parts in (2, 4):
        def route():
            owner = dc.owner_of(keys, parts)
            by_owner, order = torch.sort(owner, stable=True)
            return keys[order], torch.bincount(by_owner, minlength=parts)

        route_ms = cuda_ms(route, 3)
        owner_t, owner_q = dc.owner_of(table_keys, parts), dc.owner_of(keys, parts)
        t = {"route_ms": route_ms}
        for p in range(parts):
            table = dc.make_table(table_keys[owner_t == p].contiguous(), 31)
            routed = keys[owner_q == p].contiguous()
            got = torch.zeros(table.keys.shape, dtype=torch.int32, device=dev)
            want = torch.zeros_like(got)
            dc.count_keys(routed, 31, table, got)
            _, plain_ms = timed(lambda: dc.count_keys_plain(routed, table, want))
            if not (torch.equal(got, want) and torch.equal(got, whole[owner_t == p])):
                raise AssertionError(f"(d) D1-count-keys differs in partition {p} of {parts}")
            if p:
                continue
            n = len(table.keys)

            def library():
                idx = torch.searchsorted(table.keys, routed).clamp_(max=n - 1)
                return torch.bincount(idx[table.keys[idx] == routed], minlength=n)

            steps = dc.search_steps(table, routed)
            t.update(D1_COUNT_KEYS=cuda_ms(lambda: dc.count_keys(routed, 31, table, got), 5),
                     D1_COUNT_KEYS_plain=plain_ms, D1_COUNT_KEYS_library=cuda_ms(library, 5),
                     D1_COUNT_KEYS_work=bounds.d1_count_keys(len(routed), n, steps),
                     D1_COUNT_KEYS_cols=len(routed), d=table.bits,
                     shape=f"m={len(routed)} routed keys into partition 0 of {parts}: "
                           f"n={n} keys, k=31, d={table.bits}")
        bound, by = t["D1_COUNT_KEYS_work"].bound()
        print(f"  (d) {t['shape']} [{gpu}]: D1-count-keys {t['D1_COUNT_KEYS']:.3f} ms (plain "
              f"{t['D1_COUNT_KEYS_plain']:.3f}, torch.searchsorted + torch.bincount "
              f"{t['D1_COUNT_KEYS_library']:.3f}), bound {bound:.4f} ms by {by}, "
              f"{t['D1_COUNT_KEYS'] * 1e3 / (t['D1_COUNT_KEYS_cols'] / 1e6):.1f} us per "
              f"million keys; routing {len(keys)} keys (owner, sort, sizes) "
              f"{route_ms:.3f} ms; every partition's counts equal the plain version's and "
              f"D1-count's", flush=True)
        out[parts] = t
    del keys, table_keys, whole
    torch.cuda.empty_cache()
    return out


def kernels():
    from pangenie_tpu_torch.hmm import fb_kernels, sampling, v1_kernels
    from pangenie_tpu_torch.kmers import device_counter

    return {"K1": fb_kernels.K1, "K2": fb_kernels.K2, "K3": fb_kernels.K3,
            "K4": fb_kernels.K4, "S1": sampling.S1, "S1_CHASE": sampling.S1_CHASE,
            "V1": v1_kernels.V1, "D1_EXTRACT": device_counter.D1_EXTRACT,
            "D1_COUNT": device_counter.D1_COUNT, "D1_COUNT_KEYS": device_counter.D1_COUNT_KEYS}


def reset_launches() -> None:
    """Every kernel's launch count, and K3's and K4's by tier, to 0."""
    from pangenie_tpu_torch.hmm import fb_kernels

    for k in kernels().values():
        k.launches = 0
    for key in fb_kernels.TIER_LAUNCHES:
        fb_kernels.TIER_LAUNCHES[key] = 0


def launch_counts() -> dict:
    """Every kernel's launch count, and K3's and K4's by tier ("K3
    cluster", ...)."""
    from pangenie_tpu_torch.hmm import fb_kernels

    counts = {name: k.launches for name, k in kernels().items()}
    counts.update({f"{k} {t}": n for (k, t), n in fb_kernels.TIER_LAUNCHES.items()})
    return counts


def main() -> int:
    import torch

    if sys.argv[1:2] == ["--rank-job"]:
        return rank_job(sys.argv[2], json.loads(sys.argv[3]), sys.argv[4])
    phase("environment")
    print(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False: no GPU to smoke-test",
              file=sys.stderr)
        return 1
    gpu = gpu_line()
    print(f"  gpu: {gpu}")
    from pangenie_tpu_torch import _build

    nvcc = subprocess.run([_build._nvcc(), "--version"], check=True,
                          capture_output=True, text=True).stdout.strip()
    print("  " + nvcc.splitlines()[-1])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)

    import multiprocessing

    # the workloads are simulated on four host cores while the kernels
    # build and are checked on the card
    pool = multiprocessing.get_context("spawn").Pool(4)
    try:
        inputs = {name: pool.apply_async(timed_inputs, (params,)) for name, params in (
            ("bench", BENCH), ("sv", SV_PANEL), ("large", LARGE_PANEL),
            ("widest", WIDEST_PANEL), ("wide_subsets", WIDE_SUBSET_PANEL))}
        pool.close()
        return smoke(device, gpu, inputs)
    finally:
        pool.terminate()
        pool.join()


def smoke(device, gpu, inputs) -> int:
    import torch

    t0_smoke = time.monotonic()

    from pangenie_tpu_torch import _build

    phase("build")
    from concurrent.futures import ThreadPoolExecutor

    from pangenie_tpu_torch.kmers import native

    ks = kernels()
    t0 = time.monotonic()
    with ThreadPoolExecutor(5) as pool:
        for f in [pool.submit(fn) for fn in (
                ks["K1"].lib, ks["S1"].lib, ks["V1"].lib, ks["D1_COUNT"].lib,
                native._build_and_load)]:
            f.result()
    print(f"  built in {time.monotonic() - t0:.1f} s")
    for lib, info in _build.build_log.items():
        print(f"  {lib}: {info['seconds']:.1f} s")
        entry = ""
        for line in info["report"].splitlines():
            if "Compiling entry function" in line:  # the mangled name, templates and all
                entry = line.split("'")[1][:48]
            elif "spill" in line:
                print(f"    {entry}: {line.strip()}")
            elif "registers" in line or "error" in line.lower():
                print(f"    {entry}: {line.split(':', 1)[-1].strip()}")

    phase("kernel vs plain (and times)")
    check_fb(device, gpu)
    s1_err, s1_times = check_s1(device, gpu)
    check_s1_wide(device, gpu)
    g_err, g_times = check_generic(device, gpu)
    check_wide(device, gpu, WIDE_SHAPES)

    phase("long chromosome: sampling DP over the old 1 GiB backtrace rule")
    check_long_chromosome(device, gpu)

    phase("checkpointed sampling scan (S1-seg), and a chromosome beyond one card")
    seg_err, seg_plain_ms, seg_plain_shape = check_s1_seg(device, gpu)
    seg_times, seg_launches = check_beyond_card(device, gpu)
    seg_times.update(S1_SEG_plain=seg_plain_ms)

    phase("routes: fused (K1/K2) and generic (K3/K4) on the same columns")
    check_routes(device, gpu)

    phase("end to end")
    casedir, seconds = inputs["bench"].get()
    print(f"  bench inputs ({BENCH}) simulated in {seconds:.1f} s", flush=True)
    launches, bench_cols, phasing = run_e2e(casedir, gpu)

    phase("profile")
    run_profiled(casedir, gpu)

    phase("the bench run's own batch: K1/K2 against the plain versions, and the routes")
    fb_times = check_bench_columns(bench_cols, gpu)
    # the bench run's own batches, kept on the host for the grid over cards
    fused_cpu = type(bench_cols)(*[x.cpu() for x in bench_cols])
    phasing_cpu = (type(bench_cols)(*[x.cpu() for x in phasing["batches"][0][0]]),
                   phasing["batches"][0][1])
    del bench_cols

    phase("the bench run's own phasing batch: V1 against the plain version")
    with float64_phasing_beside(phasing, os.path.join(casedir, "out")) as compare_phasing:
        v1_times = check_phasing_batch(phasing["batches"][0], "the bench run's phasing batch",
                                       V1_PLAIN_COLUMNS, gpu)
        del phasing

        phase("sv panel: index + genotype -f")
        sv_dir, seconds = inputs["sv"].get()
        print(f"  sv inputs ({SV_PANEL}) simulated in {seconds:.1f} s", flush=True)
        sv_launches, sv_phased_launches, sv_phasing = run_sv_index_genotype(sv_dir, gpu)

        phase("the SV panel's phasing batch (P=30): V1 against the plain version, one "
              "launch against segments")
        sv_v1_times = check_phasing_batch(sv_phasing["batches"][0], "the SV panel's phasing "
                                          "batch", SV_V1_PLAIN_COLUMNS, gpu)
        check_phasing_segments(sv_phasing["batches"][0], "the SV panel's phasing batch", gpu)
        del sv_phasing
        torch.cuda.empty_cache()

        phase("the bench run's phasing VCF against the port's float64 run on the CPU")
        compare_phasing()

    phase("D1 on the first block of the bench and SV reads: against the plain versions "
          "and the host engine")
    from pangenie_tpu_torch.kmers.counter import ExactKmerCounter

    bench_segments = os.path.join(casedir, "out_path_segments.fasta")
    d1_bench = hold_d1(os.path.join(casedir, "reads.fa"), bench_segments,
                       ExactKmerCounter.count_file(bench_segments, 31, n_threads=8).keys,
                       "bench reads (the graph table given, as single passes it)", gpu)
    d1_sv = hold_d1(os.path.join(sv_dir, "reads.fa"),
                    os.path.join(sv_dir, "index_path_segments.fasta"), None,
                    "SV reads (the table built on the card, as genotype -f builds it)", gpu)

    phase("large panel: index + genotype -f + sampling at 2049 paths")
    large_dir, seconds = inputs["large"].get()
    print(f"  large panel inputs ({LARGE_PANEL}) simulated in {seconds:.1f} s", flush=True)
    (large_launches, large_err, large_times, subset_launches,
     subset_shape) = run_large_panel(large_dir, gpu)

    phase("K3/K4's cluster tier at the chunk shape of genotype -f -a "
          f"{LARGE_SUBSET}: {subset_shape}")
    torch.cuda.empty_cache()
    c_err, c_times = check_wide(device, gpu, [subset_shape])

    phase("widest panel: index + sampling at 6405 paths")
    widest_dir, seconds = inputs["widest"].get()
    print(f"  widest panel inputs ({WIDEST_PANEL}) simulated in {seconds:.1f} s", flush=True)
    widest_launches, widest_err, widest_times = run_widest_panel(widest_dir, gpu)

    phase(f"wide-subsets panel: index + genotype -f -a {WIDE_SUBSET} at 601 paths")
    wide_dir, seconds = inputs["wide_subsets"].get()
    print(f"  wide-subsets panel inputs ({WIDE_SUBSET_PANEL}) simulated in {seconds:.1f} s",
          flush=True)
    wide_launches, wide_shape = run_wide_subsets(wide_dir, gpu)

    phase(f"K3/K4's grid tier at the chunk shape of genotype -f -a {WIDE_SUBSET}: "
          f"{wide_shape}")
    torch.cuda.empty_cache()
    w_err, w_times = check_wide(device, gpu, [wide_shape])

    phase("multi-GPU (M1): (a) world 1 over NCCL, (b) two ranks sharing the card over gloo, "
          "(c) the grid over [cuda:0, cuda:0], (d) D1-count-keys on routed keys")
    t0 = time.monotonic()
    torch.cuda.empty_cache()
    m1 = run_multigpu(casedir, sv_dir, d1_bench, d1_sv, gpu)
    check_grid_over_cards(fused_cpu, phasing_cpu, gpu)
    del fused_cpu, phasing_cpu
    keys_times = check_count_keys(d1_sv, gpu)
    print(f"  multi-GPU phase wall {time.monotonic() - t0:.1f} s", flush=True)
    print(f"  smoke wall {time.monotonic() - t0_smoke:.1f} s", flush=True)

    def entry(name, source, replaces, n, e, t, key):
        bound, by = t[key + "_work"].bound()
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": n, "max_abs_err": e,
                "ms": t[key], "plain_ms": t[key + "_plain"], "bound_ms": bound,
                "bound_by": by, "bytes": t[key + "_work"].nbytes,
                "us_per_column": t[key] * 1e3 / t[key + "_cols"], "library_ms": None}

    def fused_kernel(direction):
        warp = "_warp" if fb_times["tier"] == "one warp a chain" else ""
        return f"fb_{direction}{warp}_kernel"

    def cluster_keys(P):
        ranks, warps, per_lane, _row = sampling.sweep_layout(P)
        return {"cluster_ctas": ranks, "warps_per_cta": warps, "paths_per_lane": per_lane}

    from pangenie_tpu_torch.hmm import sampling

    large_p = int(large_times["shape"].split("P=")[1])
    widest_p = int(widest_times["shape"].split("P=")[1])
    fb_src = "pangenie_tpu_torch/csrc/fb.cu"
    v1_src = "pangenie_tpu_torch/csrc/viterbi.cu"
    s1_src = "pangenie_tpu_torch/csrc/sampling_dp.cu"
    pallas = "pangenie_tpu/hmm/pallas_fb.py"
    d1_src = "pangenie_tpu_torch/csrc/kmer_count.cu"
    corpus = d1_sv["corpus"]
    d1_corpus = {"D1_EXTRACT": corpus["ms"], "D1_EXTRACT_plain": corpus["plain_ms"],
                 "D1_EXTRACT_work": corpus["work"], "D1_EXTRACT_cols": corpus["cols"]}

    def per_million(t, key):
        return t[key] * 1e3 / (t[key + "_cols"] / 1e6)

    record = {"kernels": [
        dict(entry(f"fb_forward (K1: {fused_kernel('forward')}, {fb_times['tier']})",
                   fb_src, f"{pallas}:122", launches["K1"], fb_times["K1_err"], fb_times,
                   "K1"), at=fb_times["shape"], cta_ms=fb_times["K1_cta"]),
        dict(entry(f"fb_backward (K2: {fused_kernel('backward')}, {fb_times['tier']})",
                   fb_src, f"{pallas}:148", launches["K2"], fb_times["K2_err"], fb_times,
                   "K2"), at=fb_times["shape"]),
        entry("fbe_forward (K3)", fb_src, f"{pallas}:307", sv_launches["K3"],
              g_err["K3"], g_times, "K3"),
        entry("fbe_backward (K4)", fb_src, f"{pallas}:333", sv_launches["K4"],
              g_err["K4"], g_times, "K4"),
        dict(entry(f"fbe_forward cluster tier (K3 past 128 paths: fbe_forward_cluster_kernel, "
                   f"a cluster of {c_times['ranks']} CTAs a chain, the state in registers, "
                   f"partials pushed by st.async)", fb_src, f"{pallas}:307",
                   subset_launches["K3 cluster"], c_err["K3"], c_times, "K3"),
             at=c_times["shape"], cluster_ctas=c_times["ranks"], threads=c_times["threads"]),
        dict(entry(f"fbe_backward cluster tier (K4 past 128 paths: "
                   f"fbe_backward_cluster_kernel, a cluster of {c_times['ranks']} CTAs a "
                   f"chain, the state in registers, partials pushed by st.async)", fb_src,
                   f"{pallas}:333", subset_launches["K4 cluster"], c_err["K4"], c_times, "K4"),
             at=c_times["shape"], cluster_ctas=c_times["ranks"], threads=c_times["threads"]),
        dict(entry(f"fbe_forward grid tier (K3 past what a cluster holds: "
                   f"fbe_forward_grid_kernel, {w_times['ranks']} CTAs a chain, the band in "
                   f"{w_times['store']}, column sums merged through L2 in {w_times['hops']} "
                   f"hops)", fb_src, f"{pallas}:307", wide_launches["K3 grid"], w_err["K3"],
                   w_times, "K3"),
             at=w_times["shape"], grid_ctas=w_times["ranks"], threads=w_times["threads"]),
        dict(entry(f"fbe_backward grid tier (K4 past what a cluster holds: "
                   f"fbe_backward_grid_kernel, {w_times['ranks']} CTAs a chain, the band in "
                   f"{w_times['store']}, column sums merged through L2 in {w_times['hops']} "
                   f"hops)", fb_src, f"{pallas}:333", wide_launches["K4 grid"], w_err["K4"],
                   w_times, "K4"),
             at=w_times["shape"], grid_ctas=w_times["ranks"], threads=w_times["threads"]),
        entry("viterbi_iteration (S1: sweep and chase)", s1_src,
              "pangenie_tpu/hmm/sampling.py:174", launches["S1"], s1_err, s1_times, "S1"),
        entry("backtrace chase (S1)", s1_src, "pangenie_tpu/hmm/sampling.py:232",
              launches["S1_CHASE"], s1_err, s1_times, "S1_CHASE"),
        dict(entry(f"viterbi_iteration at P={large_p} (S1: s1_sweep_kernel as "
                   f"{s1_layout(large_p)} a chromosome, partials pushed by st.async)",
                   s1_src, "pangenie_tpu/hmm/sampling.py:174", large_launches["S1"], large_err,
                   large_times, "S1"), at=large_times["shape"], **cluster_keys(large_p)),
        dict(entry(f"viterbi_iteration at P={widest_p} (S1: s1_sweep_kernel as "
                   f"{s1_layout(widest_p)} a chromosome, partials pushed by st.async)",
                   s1_src, "pangenie_tpu/hmm/sampling.py:174",
                   widest_launches["S1"], widest_err, widest_times, "S1"),
             at=widest_times["shape"], **cluster_keys(widest_p)),
        dict(entry(f"viterbi (V1: v1_viterbi_kernel, a CTA of {v1_times['warps']} warps a "
                   f"chain, the top-2 statistics as merge trees, the chase in the same "
                   f"launch)", v1_src, "pangenie_tpu/hmm/viterbi.py:214",
                   launches["V1"] + sv_phased_launches["V1"],
                   max(v1_times["V1_err"], sv_v1_times["V1_err"]), v1_times, "V1"),
             at=v1_times["shape"], plain_at=v1_times["plain_at"],
             launches_by_path={"bench single -g -p": launches["V1"],
                               "sv genotype -f -g -p": sv_phased_launches["V1"]},
             sv=dict(at=sv_v1_times["shape"], plain_at=sv_v1_times["plain_at"],
                     ms=sv_v1_times["V1"], plain_ms=sv_v1_times["V1_plain"],
                     bound_ms=sv_v1_times["V1_work"].bound()[0],
                     bound_by=sv_v1_times["V1_work"].bound()[1],
                     us_per_column=sv_v1_times["V1"] * 1e3 / sv_v1_times["V1_cols"],
                     max_abs_err=sv_v1_times["V1_err"], warps=sv_v1_times["warps"])),
        dict(entry(f"viterbi_iteration_segmented (S1-seg: s1_sweep_kernel as "
                   f"{s1_layout(BEYOND_SHAPE[2])} a chromosome, sweeps with entry and exit "
                   f"rows, chases from handed-back states)", s1_src,
                   "pangenie_tpu/hmm/sampling.py:652", sum(seg_launches.values()), seg_err,
                   seg_times, "S1_SEG"), plain_at=seg_plain_shape,
             **cluster_keys(BEYOND_SHAPE[2])),
        dict(entry("canonical k-mers of packed blocks (D1-extract: d1_extract_kernel, one "
                   "thread a window, its key from funnel shifts), the SV run's table build",
                   d1_src,
                   "pangenie_tpu/kmers/device_counter.py:142",
                   launches["D1_EXTRACT"] + sv_launches["D1_EXTRACT"], 0, d1_corpus,
                   "D1_EXTRACT"), at=corpus["shape"],
             us_per_million_windows=per_million(d1_corpus, "D1_EXTRACT"),
             launches_by_path={"bench single -g -p": launches["D1_EXTRACT"],
                               "sv index + genotype -f": sv_launches["D1_EXTRACT"]},
             reads=dict(at=d1_sv["shape"], ms=d1_sv["D1_EXTRACT"],
                        plain_ms=d1_sv["D1_EXTRACT_plain"])),
        dict(entry("read k-mer counting into the sorted table (D1-count: d1_count_kernel, "
                   "one thread a window, a directory sized to the table, the bucket read "
                   "in 16-byte pairs, atomicAdd)",
                   d1_src, "pangenie_tpu/kmers/device_counter.py:430",
                   launches["D1_COUNT"] + sv_launches["D1_COUNT"], 0, d1_bench, "D1_COUNT"),
             at=d1_bench["shape"], directory_bits=d1_bench["d"],
             library_ms=d1_bench["D1_COUNT_library"],
             library="torch.searchsorted, then torch.bincount(minlength=n)",
             us_per_million_windows=per_million(d1_bench, "D1_COUNT"),
             also_replaces="pangenie_tpu/kmers/device_counter.py:458, :474",
             launches_by_path={"bench single -g -p": launches["D1_COUNT"],
                               "sv index + genotype -f": sv_launches["D1_COUNT"]},
             sv=dict(at=d1_sv["shape"], directory_bits=d1_sv["d"], ms=d1_sv["D1_COUNT"],
                     plain_ms=d1_sv["D1_COUNT_plain"],
                     library_ms=d1_sv["D1_COUNT_library"],
                     bound_ms=d1_sv["D1_COUNT_work"].bound()[0],
                     bound_by=d1_sv["D1_COUNT_work"].bound()[1],
                     us_per_million_windows=per_million(d1_sv, "D1_COUNT"))),
        dict(entry("read k-mer counting of routed keys into a partition of the graph table "
                   "(D1-count-keys: d1_count_keys_kernel, one thread a key, D1-count's "
                   "search, atomicAdd)", d1_src,
                   "pangenie_tpu/kmers/device_counter.py:593",
                   m1["launches"], 0, keys_times[2], "D1_COUNT_KEYS"),
             at=keys_times[2]["shape"], directory_bits=keys_times[2]["d"],
             library_ms=keys_times[2]["D1_COUNT_KEYS_library"],
             library="torch.searchsorted, then torch.bincount(minlength=n)",
             launches_on="two ranks over gloo: SV genotype -f through the CLI, "
                         "_read_counter's partitioned route",
             route_ms=keys_times[2]["route_ms"], check_launches=m1["check_launches"],
             walls=m1["walls"],
             four=dict(at=keys_times[4]["shape"], ms=keys_times[4]["D1_COUNT_KEYS"],
                       plain_ms=keys_times[4]["D1_COUNT_KEYS_plain"],
                       library_ms=keys_times[4]["D1_COUNT_KEYS_library"],
                       bound_ms=keys_times[4]["D1_COUNT_KEYS_work"].bound()[0],
                       route_ms=keys_times[4]["route_ms"])),
    ]}
    print(json.dumps(record))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
