"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as it runs; any failure exits non-zero:

1. environment: torch/CUDA versions, GPU name and power limit, nvcc;
2. build: the CUDA kernels (K1/K2 in csrc/fb.cu, S1 in
   csrc/sampling_dp.cu) and the host k-mer engine, from this checkout;
3. kernel vs plain on the card, with the times of both: K1/K2 against
   the plain forward-backward (rtol=2e-4, atol=1e-7, float32) at the
   main path's shape B=2, N=65,536, P=16 and at B=128, N=4096, P=32,
   K=16 and B=2, N=4096, P=16; S1 against the plain sampling DP, bit
   for bit, for one masked iteration at the main path's shape C=2,
   N=55,040, P=123 and for 15 greedy iterations at C=2, N=4096, P=123;
4. end to end: the bench workload (20 Mb, 2 chromosomes, 61 samples =
   123 paths, 12x 150 bp reads, seed 11) is simulated once into
   build/smoke_inputs/ and genotyped with the port's single command on
   CUDA; the run must dispatch to the kernels, launch each of them, load
   the native k-mer engine and reach genotype concordance >= 0.99
   against the truth;
5. profile: the same command once more under torch.profiler; its VCF
   body must equal the first run's, and the device's busy time and idle
   share over the run are printed.

The last three lines of standard output are the kernels' JSON record
(times at the main path's shapes), the GPU's name and power limit, and
the device JSON record. The script imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

RTOL, ATOL = 2e-4, 1e-7
# (B, N, P, K); the first is the main path's shape at the bench workload
FB_SHAPES = [(2, 65536, 16, 16), (128, 4096, 32, 16), (2, 4096, 16, 16)]
MAIN_S1_SHAPE = (2, 55040, 123, 4)                     # (C, N, P, A)
S1_GREEDY_SHAPE = (2, 4096, 123, 4, 15)                # (C, N, P, A, iterations)
E2E_MB = 20.0   # the bench workload's size (bench.py:191-192), not cut


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


def check_fb(device, gpu):
    """K1/K2 against the plain forward-backward at every FB_SHAPES entry.
    Returns the largest absolute errors and the times at the main
    path's shape."""
    import torch

    from pangenie_tpu_torch.hmm import fb_kernels
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
        }
        times[(B, N, P, K)] = t
        shape = f"B={B} N={N} P={P} K={K}"
        print(f"  fb {shape}: ok (K1 max_abs_err {e1:.3e}, K2 max_abs_err {e2:.3e})")
        print(f"  times {shape} [{gpu}]: K1 {t['K1']:.3f} ms, plain "
              f"{t['K1_plain']:.3f} ms; K2 {t['K2']:.3f} ms, plain "
              f"{t['K2_plain']:.3f} ms", flush=True)
        del cols, ea, a_k, c_k, a_p, c_p, p_k, p_p
    return err, times[FB_SHAPES[0]]


def check_s1(device, gpu):
    """S1 against the plain sampling DP, bit for bit: one masked
    iteration at the main path's shape, then the greedy loop.  Returns
    the largest absolute difference (0) and the times at the main
    path's shape."""
    import numpy as np
    import torch

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
         "S1_plain": s1_plain}
    print(f"  s1 C={C} N={N} P={P}, one masked iteration: bit-identical "
          f"(paths and scores)")
    print(f"  times C={C} N={N} P={P} [{gpu}]: S1 {t['S1']:.3f} ms, plain "
          f"{t['S1_plain']:.3f} ms per iteration", flush=True)

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


def build_inputs(mb: float, workdir: str) -> str:
    """The bench workload (bench.py / benchmarks/genome_scale.py), made
    with the port's simulator and cached by its parameters."""
    import numpy as np

    from pangenie_tpu_torch.utils import simulate as sim

    chroms, samples, coverage, read_len, distance, seed = 2, 61, 12.0, 150, 150, 11
    tag = f"mb{mb}_c{chroms}_s{samples}_cov{coverage}_d{distance}_seed{seed}"
    casedir = os.path.join(workdir, tag)
    if os.path.exists(os.path.join(casedir, "DONE")):
        return casedir
    os.makedirs(casedir, exist_ok=True)
    rng = np.random.default_rng(seed)
    length = int(mb / chroms * 1_000_000)
    n_var = 0
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
                                          mean_distance=distance)
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
        out.write(f"variants={n_var}\n")
    return casedir


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
    from pangenie_tpu_torch.hmm import batch, fb_kernels, sampling
    from pangenie_tpu_torch.kmers import native
    from pangenie_tpu_torch.utils import timer

    outpref = os.path.join(casedir, "out")
    for k in (fb_kernels.K1, fb_kernels.K2, sampling.S1):
        k.launches = 0
    wall = _run_single(casedir, outpref)
    launches = {
        "K1": fb_kernels.K1.launches, "K2": fb_kernels.K2.launches,
        "S1": sampling.S1.launches,
    }
    if batch.last_dispatch != "cuda_fused":
        raise AssertionError(f"dispatch was {batch.last_dispatch}, not cuda_fused")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
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


def run_profiled(casedir: str, gpu: str) -> None:
    """The single command once more under torch.profiler: the device's
    busy time is the union of its kernel and copy intervals, and the
    idle share is the rest of the traced wall."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pangenie_tpu_torch.utils import timer

    outpref = os.path.join(casedir, "out_profiled")
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = _run_single(casedir, outpref)
    if _vcf_body(outpref + "_genotyping.vcf") != _vcf_body(
        os.path.join(casedir, "out_genotyping.vcf")
    ):
        raise AssertionError("the profiled run's VCF differs from the first run's")
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
    busy = busy_us / 1e6
    print(f"  profiled e2e [{gpu}]: wall {wall:.2f} s, device busy {busy:.3f} s, "
          f"idle share {1 - busy / wall:.4f}, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; VCF body equals "
          f"the first run's")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    for name, (dt, n) in top:
        print(f"    device {dt:.3f} s over {n} launches: {name[:90]}")
    print(f"  phase walls (s): "
          f"{json.dumps({k: round(v, 2) for k, v in timer.last_phases.items()})}",
          flush=True)


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

    phase("build")
    from pangenie_tpu_torch.hmm import fb_kernels, sampling
    from pangenie_tpu_torch.kmers import native

    t0 = time.monotonic()
    fb_kernels.K1.lib()
    sampling.S1.lib()
    native._build_and_load()
    print(f"  built in {time.monotonic() - t0:.1f} s")
    for lib, info in _build.build_log.items():
        print(f"  {lib}: {info['seconds']:.1f} s")
        for line in info["report"].splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                print("    " + line.strip())

    phase("kernel vs plain (and times)")
    err, fb_times = check_fb(device, gpu)
    s1_err, s1_times = check_s1(device, gpu)

    phase("end to end")
    t0 = time.monotonic()
    casedir = build_inputs(E2E_MB, os.path.join(ROOT, "build", "smoke_inputs"))
    print(f"  inputs ({E2E_MB} Mb) ready in {time.monotonic() - t0:.1f} s", flush=True)
    launches = run_e2e(casedir, gpu)

    phase("profile")
    run_profiled(casedir, gpu)

    record = {"kernels": [
        {"name": "fb_forward (K1)", "route": "cuda",
         "source": "pangenie_tpu_torch/csrc/fb.cu",
         "replaces": "pangenie_tpu/hmm/pallas_fb.py:122",
         "launches": launches["K1"], "max_abs_err": err["K1"],
         "ms": fb_times["K1"], "plain_ms": fb_times["K1_plain"]},
        {"name": "fb_backward (K2)", "route": "cuda",
         "source": "pangenie_tpu_torch/csrc/fb.cu",
         "replaces": "pangenie_tpu/hmm/pallas_fb.py:148",
         "launches": launches["K2"], "max_abs_err": err["K2"],
         "ms": fb_times["K2"], "plain_ms": fb_times["K2_plain"]},
        {"name": "viterbi_iteration (S1)", "route": "cuda",
         "source": "pangenie_tpu_torch/csrc/sampling_dp.cu",
         "replaces": "pangenie_tpu/hmm/sampling.py:173",
         "launches": launches["S1"], "max_abs_err": s1_err,
         "ms": s1_times["S1"], "plain_ms": s1_times["S1_plain"]},
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
