"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as it runs; any failure exits non-zero:

1. environment: torch/CUDA versions, GPU name and power limit, nvcc;
2. build: the CUDA kernels (K1-K4 in csrc/fb.cu, S1 in
   csrc/sampling_dp.cu) and the host k-mer engine, from this checkout,
   one compiler per source, all at once.
   The two end-to-end workloads below are simulated meanwhile, in two
   worker processes, once each into build/smoke_inputs/;
3. kernel vs plain on the card, with the times of both (float32,
   rtol=2e-4, atol=1e-7 unless bit-identical): K1/K2 against the plain
   forward-backward at the bench path's shape B=2, N=65,536, P=16 and at
   B=128, N=4096, P=32, K=16 and B=2, N=4096, P=16; S1 against the plain
   sampling DP, bit for bit, for one masked iteration at the bench
   path's shape C=2, N=55,040, P=123 and for 15 greedy iterations at
   C=2, N=4096, P=123; K3/K4 against their plain versions at the SV
   path's shape B=1, N=131,072, P=89, K=32, A=16, at B=2, N=8192, P=89
   with 97/2/1% of the columns at A=2/4/16 (where the whole chunked
   route in chunks of 2048 and the fused route through K1/K2 on the
   same columns are timed too) and at B=32, N=4096, P=32, K=32, A=16.
   Their columns carry k-mers only on alleles they have and read
   counts from a true path pair (utils/multiallelic.py), so raw
   posteriors stay far from float32's underflow: every column's sum
   must exceed POST_FLOOR, and the columns, divided by their sums, are
   compared at the tolerance above. At every K3/K4 shape two launches
   must give the same bits, and a batch of B=3 chains at P=89 with
   padding (all-zero E after one chain's is_last, and one chain all
   padding) goes through K3/K4 against the plain versions too. Each
   kernel's bound (hmm/bounds.py: bytes over 3.35 TB/s or operations
   over 67 TFLOP/s, the larger) is printed beside its time, with the
   bytes/s achieved;
4. end to end: the bench workload (20 Mb, 2 chromosomes, 61 samples =
   123 paths, 12x 150 bp reads, seed 11) genotyped with the port's
   single command on CUDA; the run must dispatch to the fused kernels,
   launch K1, K2 and S1, load the native k-mer engine and reach genotype
   concordance >= 0.99 against the truth;
5. profile: the same command once more under torch.profiler; its VCF
   body must equal the first run's, and the device's busy time and idle
   share over the run are printed;
6. SV panel: one 20 Mb chromosome (about 150,000 variants, so more than
   2^17 HMM columns), 44 samples = 89 paths (no auto-sampling), 1% SV
   sites each rewritten into 8-15 distinct 100-400 bp insertion ALTs,
   12x 150 bp reads, seed 13; ``index`` then ``genotype -f`` on CUDA.
   The run must dispatch to the generic kernels, launch K3 and K4, walk
   the chromosome in more than one chunk and reach concordance >= 0.98;
   ``genotype -f`` then runs once more under torch.profiler, for the
   device time by kernel and the idle share.

Each end-to-end path runs with every kernel's launch count set to 0
just before it and read just after. The last three lines of standard
output are the kernels' JSON record (launches from those paths; times,
bound, bytes and us per column at their shapes), the GPU's name and
power limit, and the device JSON record. The script imports nothing of
JAX.
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
# (B, N, P, K); the first is the bench path's shape
FB_SHAPES = [(2, 65536, 16, 16), (128, 4096, 32, 16), (2, 4096, 16, 16)]
MAIN_S1_SHAPE = (2, 55040, 123, 4)                     # (C, N, P, A)
S1_GREEDY_SHAPE = (2, 4096, 123, 4, 15)                # (C, N, P, A, iterations)
# (B, N, P, K, mixed allele counts, forced chunk), all at A=16; the first
# is the SV path's shape (its first chunk: fb_generic.SEGMENT columns)
GENERIC_SHAPES = [(1, 1 << 17, 89, 32, True, 0), (2, 8192, 89, 32, True, 2048),
                  (32, 4096, 32, 32, False, 0)]
# (B, N, P, padded chain, padding from) of the padding check
PADDED_SHAPE = (3, 2048, 89, 2, 1500)
# K3/K4 at the SV path's shape, as the redesign's acceptance set them (ms)
GENERIC_TARGETS = {"K3": 550.0, "K4": 730.0}
# the bench workload (bench.py:191-192, not cut) and the SV panel
BENCH = dict(mb=20.0, chroms=2, samples=61, distance=150, seed=11)
SV_PANEL = dict(mb=20.0, chroms=1, samples=44, distance=100, seed=13,
                sv_fraction=0.01, sv_alts=(8, 15))


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


def check_fb(device, gpu):
    """K1/K2 against the plain forward-backward at every FB_SHAPES entry.
    Returns the largest absolute errors and the times at the main
    path's shape."""
    import torch

    from pangenie_tpu_torch.hmm import bounds, fb_kernels
    from pangenie_tpu_torch.hmm.forward_backward import (
        allele_emissions, backward_plain, columns_from_numpy, forward_plain,
    )
    from pangenie_tpu_torch.utils.synthetic import synthetic_columns

    err = {"K1": 0.0, "K2": 0.0}
    times = {}
    for B, N, P, K in FB_SHAPES:
        cols = columns_from_numpy(
            synthetic_columns(n_columns=N, n_paths=P, n_kmers=K, batch_dims=(B,),
                              seed=7, dtype="float32"),
            device, torch.float32,
        )
        ea = allele_emissions(cols)
        al, tr, last = cols.allele_local, cols.trans, cols.is_last
        (a_k, c_k), _ = timed(lambda: fb_kernels.forward(ea, al, tr))
        (a_p, c_p), k1_plain = timed(lambda: forward_plain(ea, al, tr))
        torch.testing.assert_close(a_k, a_p, rtol=RTOL, atol=ATOL)
        torch.testing.assert_close(c_k, c_p, rtol=RTOL, atol=ATOL)
        p_k, _ = timed(lambda: fb_kernels.backward(a_k, c_k, ea, al, tr, last))
        p_p, k2_plain = timed(lambda: backward_plain(a_p, c_p, ea, al, tr, last))
        torch.testing.assert_close(p_k, p_p, rtol=RTOL, atol=ATOL)
        e1 = max(float((a_k - a_p).abs().max()), float((c_k - c_p).abs().max()))
        e2 = float((p_k - p_p).abs().max())
        err["K1"], err["K2"] = max(err["K1"], e1), max(err["K2"], e2)
        t = {
            "K1": cuda_ms(lambda: fb_kernels.forward(ea, al, tr), 3),
            "K1_plain": k1_plain,
            "K2": cuda_ms(lambda: fb_kernels.backward(a_k, c_k, ea, al, tr, last), 3),
            "K2_plain": k2_plain,
            "K1_work": bounds.k1(B, N, P, ea.shape[-1]), "K1_cols": N,
            "K2_work": bounds.k2(B, N, P, ea.shape[-1]), "K2_cols": N,
        }
        times[(B, N, P, K)] = t
        shape = f"B={B} N={N} P={P} K={K}"
        print(f"  fb {shape}: ok (K1 max_abs_err {e1:.3e}, K2 max_abs_err {e2:.3e})")
        print(f"  times {shape} [{gpu}]: K1 {t['K1']:.3f} ms, plain "
              f"{t['K1_plain']:.3f} ms; K2 {t['K2']:.3f} ms, plain "
              f"{t['K2_plain']:.3f} ms; {against_bound(t, 'K1')}; "
              f"{against_bound(t, 'K2')}", flush=True)
        del cols, ea, a_k, c_k, a_p, c_p, p_k, p_p
    return err, times[FB_SHAPES[0]]


def check_s1(device, gpu):
    """S1 against the plain sampling DP, bit for bit: one masked
    iteration at the main path's shape, then the greedy loop.  Returns
    the largest absolute difference (0) and the times at the main
    path's shape."""
    import numpy as np
    import torch

    from pangenie_tpu_torch.hmm import bounds
    from pangenie_tpu_torch.hmm.sampling import (
        sample_group, viterbi_iteration, viterbi_iteration_plain,
    )

    rng = np.random.default_rng(5)
    C, N, P, A = MAIN_S1_SHAPE
    # capped costs as the penalty updates leave them (<= 25), alleles as
    # a panel carries them, and a third of the paths masked as after a
    # few greedy iterations
    costs = torch.from_numpy(rng.integers(0, 26, (C, N, A)).astype(np.int32)).to(device)
    alleles = torch.from_numpy(rng.integers(0, A, (C, N, P))).to(device)
    path_cost = torch.gather(costs, 2, alleles).to(torch.int32).contiguous()
    mask = torch.from_numpy(rng.random((C, N, P)) > 0.3).to(device)
    switch = torch.from_numpy(rng.integers(20, 40, (C, N)).astype(np.int32)).to(device)
    (pk, sk), _ = timed(lambda: viterbi_iteration(path_cost, mask, switch))
    (pp, sp), s1_plain = timed(lambda: viterbi_iteration_plain(path_cost, mask, switch))
    if not (torch.equal(pk, pp) and torch.equal(sk, sp)):
        raise AssertionError("S1 paths or scores differ from the plain DP "
                             "at the main path's shape")
    max_err = max(float((pk.long() - pp.long()).abs().max()),
                  float((sk - sp).abs().max()))
    t = {"S1": cuda_ms(lambda: viterbi_iteration(path_cost, mask, switch), 3),
         "S1_plain": s1_plain, "S1_work": bounds.s1(C, N, P), "S1_cols": N}
    print(f"  s1 C={C} N={N} P={P}, one masked iteration: bit-identical "
          f"(paths and scores)")
    print(f"  times C={C} N={N} P={P} [{gpu}]: S1 {t['S1']:.3f} ms, plain "
          f"{t['S1_plain']:.3f} ms per iteration; {against_bound(t, 'S1')}",
          flush=True)

    C, N, P, A, iters = S1_GREEDY_SHAPE
    # costs 0..3 force ties; switch costs on the scale of real ones
    costs = torch.from_numpy(rng.integers(0, 4, (C, N, A)).astype(np.int32)).to(device)
    alleles = torch.from_numpy(rng.integers(0, A, (C, N, P))).to(device)
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
    """Holds raw posteriors [B, N, X, X] column by column: no column's
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
    the plain versions, and the fused route (emissions, K1, K2) on the
    same columns. Returns the largest absolute errors (K4's: of the
    divided posteriors and of the outgoing beta) and the times at the SV
    path's shape."""
    import torch

    from pangenie_tpu_torch.hmm import bounds, fb_generic, fb_kernels
    from pangenie_tpu_torch.hmm.forward_backward import allele_emissions

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

            def fused():
                ea = allele_emissions(cols)
                a, c = fb_kernels.forward(ea, cols.allele_local, cols.trans)
                return fb_kernels.backward(a, c, ea, cols.allele_local, cols.trans,
                                           cols.is_last)

            f_k, fused_ms = timed(fused)
            e_fused, _ = posterior_error(f_k, g_k, f"fused vs generic route {shape}")
            ea = allele_emissions(cols)
            a1, c1 = fb_kernels.forward(ea, cols.allele_local, cols.trans)
            k1 = cuda_ms(lambda: fb_kernels.forward(ea, cols.allele_local, cols.trans), 3)
            k2 = cuda_ms(lambda: fb_kernels.backward(a1, c1, ea, cols.allele_local,
                                                     cols.trans, cols.is_last), 3)
            print(f"  chunked route {shape}, {walk[2]} chunks of {chunk}: kernels vs "
                  f"plain ok (posteriors divided by their column sums max_abs_err "
                  f"{e_route:.3e}, smallest column sum {low_route:.3e}); fused route "
                  f"vs generic route max_abs_err {e_fused:.3e} (divided likewise)")
            print(f"  A>8 rule on the card {shape} [{gpu}]: generic route "
                  f"(bucketed emissions, K3/K4 in chunks, collapse) {gen_ms:.3f} ms, "
                  f"plain {gen_plain:.3f} ms; fused route (emissions, K1, K2) "
                  f"{fused_ms:.3f} ms; whole-N kernels only: K1 {k1:.3f} + K2 "
                  f"{k2:.3f} ms vs K3 {t['K3']:.3f} + K4 {t['K4']:.3f} ms", flush=True)
            del g_k, g_p, f_k, ea, a1, c1
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


def build_inputs(workdir: str, mb: float, chroms: int, samples: int,
                 distance: int, seed: int, sv_fraction: float = 0.0,
                 sv_alts=None) -> str:
    """A workload made with the port's simulator (as bench.py and
    benchmarks/genome_scale.py make theirs), 12x 150 bp reads of sample
    0, cached by its parameters. With ``sv_alts`` the SV sites are
    rewritten by :func:`rewrite_sv_sites`."""
    import numpy as np

    from pangenie_tpu_torch.utils import simulate as sim

    coverage, read_len = 12.0, 150
    tag = f"mb{mb}_c{chroms}_s{samples}_cov{coverage}_d{distance}_seed{seed}"
    if sv_alts:
        tag += f"_sv{sv_fraction}_alts{sv_alts[0]}-{sv_alts[1]}"
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
            variants = sim.simulate_panel(ref, nr_samples=samples, rng=rng,
                                          mean_distance=distance,
                                          sv_fraction=sv_fraction)
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
    """The port's single command on CUDA; returns its wall in seconds."""
    import torch

    from pangenie_tpu_torch.commands import run_single_command

    t0 = time.monotonic()
    run_single_command(
        os.path.join(casedir, "reads.fa"), os.path.join(casedir, "ref.fa"),
        os.path.join(casedir, "panel.vcf"), 31, outpref,
        nr_jellyfish_threads=2, nr_core_threads=2, device="cuda",
    )
    torch.cuda.synchronize()
    return time.monotonic() - t0


def run_e2e(casedir: str, gpu: str):
    from pangenie_tpu_torch.eval.concordance import genotype_concordance
    from pangenie_tpu_torch.hmm import batch
    from pangenie_tpu_torch.kmers import native
    from pangenie_tpu_torch.utils import timer

    outpref = os.path.join(casedir, "out")
    for k in kernels().values():
        k.launches = 0
    wall = _run_single(casedir, outpref)
    launches = {name: k.launches for name, k in kernels().items()}
    if batch.last_dispatch != "cuda_fused":
        raise AssertionError(f"dispatch was {batch.last_dispatch}, not cuda_fused")
    for name in ("K1", "K2", "S1"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the bench path")
    if native._LIB is None:
        raise AssertionError("the native k-mer engine was not loaded")
    result = genotype_concordance(
        outpref + "_genotyping.vcf", os.path.join(casedir, "truth.vcf")
    )
    print(f"  e2e [{gpu}]: wall {wall:.2f} s, {result.total} variants, "
          f"{result.total / wall:.1f} variants/s, concordance "
          f"{result.concordance:.5f}, launches {launches}")
    print(f"  phase walls (s): "
          f"{json.dumps({k: round(v, 2) for k, v in timer.last_phases.items()})}",
          flush=True)
    if result.concordance < 0.99:
        raise AssertionError(f"concordance {result.concordance} < 0.99")
    return launches


def _vcf_body(path: str) -> list:
    with open(path) as f:
        return [line for line in f if not line.startswith("##")]


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
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; VCF body equals "
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
    if _vcf_body(outpref + "_genotyping.vcf") != _vcf_body(
        os.path.join(casedir, "out_genotyping.vcf")
    ):
        raise AssertionError("the profiled run's VCF differs from the first run's")
    print_profile("e2e", wall, busy, by_name, gpu)


def run_sv_index_genotype(casedir: str, gpu: str):
    """``index`` then ``genotype -f`` on CUDA over the SV panel, then
    ``genotype -f`` once more under torch.profiler. Returns the launch
    counts of the first ``index`` + ``genotype -f``."""
    import torch

    from pangenie_tpu_torch import commands
    from pangenie_tpu_torch.eval.concordance import genotype_concordance
    from pangenie_tpu_torch.hmm import batch, fb_generic
    from pangenie_tpu_torch.utils import timer

    prefix = os.path.join(casedir, "index")
    outpref = os.path.join(casedir, "out")

    def genotype(out):
        commands.run_genotype_command(
            prefix, os.path.join(casedir, "reads.fa"), out,
            nr_jellyfish_threads=2, nr_core_threads=2, device="cuda",
        )

    for k in kernels().values():
        k.launches = 0
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
    launches = {name: k.launches for name, k in kernels().items()}
    peak = torch.cuda.max_memory_allocated()
    genotype_phases = dict(timer.last_phases)
    # one chromosome, so the HMM's one run is its only chunked walk
    walk = fb_generic.last_walk
    if batch.last_dispatch != "cuda_generic":
        raise AssertionError(f"dispatch was {batch.last_dispatch}, not cuda_generic")
    for name in ("K3", "K4"):
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
    wall, busy, by_name = profile_device(lambda: genotype(profiled))
    if _vcf_body(profiled + "_genotyping.vcf") != _vcf_body(outpref + "_genotyping.vcf"):
        raise AssertionError("the profiled genotype -f VCF differs from the first run's")
    print_profile("sv genotype -f", wall, busy, by_name, gpu)
    # K3/K4 are templates: the profiler names them "void fbe_forward_kernel<6, 3>(...)"
    k34 = sum(dt for name, (dt, _n) in by_name.items() if "fbe_" in name)
    copies = sum(dt for name, (dt, _n) in by_name.items() if "Memcpy" in name
                 or "Memset" in name)
    print(f"  sv genotype -f device time: K3+K4 {k34:.3f} s, copies {copies:.3f} s, "
          f"other kernels (emissions, collapse, ...) {busy - k34 - copies:.3f} s of "
          f"{busy:.3f} s busy; HMM phase wall "
          f"{timer.last_phases.get('genotyping (HMM)', float('nan')):.2f} s", flush=True)
    return launches


def kernels():
    from pangenie_tpu_torch.hmm import fb_kernels, sampling

    return {"K1": fb_kernels.K1, "K2": fb_kernels.K2, "K3": fb_kernels.K3,
            "K4": fb_kernels.K4, "S1": sampling.S1}


def main() -> int:
    import torch

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

    # the workloads are simulated on two host cores while the kernels
    # build and are checked on the card
    pool = multiprocessing.get_context("spawn").Pool(2)
    try:
        bench_inputs = pool.apply_async(timed_inputs, (BENCH,))
        sv_inputs = pool.apply_async(timed_inputs, (SV_PANEL,))
        pool.close()
        return smoke(device, gpu, bench_inputs, sv_inputs)
    finally:
        pool.terminate()
        pool.join()


def smoke(device, gpu, bench_inputs, sv_inputs) -> int:
    import torch

    from pangenie_tpu_torch import _build

    phase("build")
    from concurrent.futures import ThreadPoolExecutor

    from pangenie_tpu_torch.kmers import native

    ks = kernels()
    t0 = time.monotonic()
    with ThreadPoolExecutor(3) as pool:
        for f in [pool.submit(fn) for fn in (
                ks["K1"].lib, ks["S1"].lib, native._build_and_load)]:
            f.result()
    print(f"  built in {time.monotonic() - t0:.1f} s")
    for lib, info in _build.build_log.items():
        print(f"  {lib}: {info['seconds']:.1f} s")
        for line in info["report"].splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                print("    " + line.strip())

    phase("kernel vs plain (and times)")
    err, fb_times = check_fb(device, gpu)
    s1_err, s1_times = check_s1(device, gpu)
    g_err, g_times = check_generic(device, gpu)

    phase("end to end")
    casedir, seconds = bench_inputs.get()
    print(f"  bench inputs ({BENCH}) simulated in {seconds:.1f} s", flush=True)
    launches = run_e2e(casedir, gpu)

    phase("profile")
    run_profiled(casedir, gpu)

    phase("sv panel: index + genotype -f")
    sv_dir, seconds = sv_inputs.get()
    print(f"  sv inputs ({SV_PANEL}) simulated in {seconds:.1f} s", flush=True)
    sv_launches = run_sv_index_genotype(sv_dir, gpu)

    def entry(name, source, replaces, n, e, t, key):
        bound, by = t[key + "_work"].bound()
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": n, "max_abs_err": e,
                "ms": t[key], "plain_ms": t[key + "_plain"], "bound_ms": bound,
                "bound_by": by, "bytes": t[key + "_work"].nbytes,
                "us_per_column": t[key] * 1e3 / t[key + "_cols"], "library_ms": None}

    fb_src = "pangenie_tpu_torch/csrc/fb.cu"
    pallas = "pangenie_tpu/hmm/pallas_fb.py"
    record = {"kernels": [
        entry("fb_forward (K1)", fb_src, f"{pallas}:122", launches["K1"],
              err["K1"], fb_times, "K1"),
        entry("fb_backward (K2)", fb_src, f"{pallas}:148", launches["K2"],
              err["K2"], fb_times, "K2"),
        entry("fbe_forward (K3)", fb_src, f"{pallas}:307", sv_launches["K3"],
              g_err["K3"], g_times, "K3"),
        entry("fbe_backward (K4)", fb_src, f"{pallas}:333", sv_launches["K4"],
              g_err["K4"], g_times, "K4"),
        entry("viterbi_iteration (S1)", "pangenie_tpu_torch/csrc/sampling_dp.cu",
              "pangenie_tpu/hmm/sampling.py:173", launches["S1"], s1_err,
              s1_times, "S1"),
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
