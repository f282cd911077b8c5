"""Times kernel S1 at chip_smoke.py's main sampling shape on one NVIDIA GPU.

    python3 tools/s1_times.py [--root DIR] [--reps 3] [--variants] [--wide]
                              [--ranks] [--beyond]

Builds the inputs as chip_smoke.check_s1 does (seed 5; C=2, N=55,040,
P=123, A=4: costs 0..25 gathered through random alleles, 30% of the
paths masked, switch costs 20..39) and times ``sampling.viterbi_iteration``
with CUDA events, the mean of ``--reps`` calls after a warm-up. ``--root``
imports ``pangenie_tpu_torch`` from another checkout (default: the one
holding this script), so two versions can be timed in turns on one card.
Where that checkout's S1 is a sweep and a chase (``sampling.s1_sweep``),
each is timed alone too.

``--variants`` also builds ``tools/s1_split.cu`` with nvcc into
``build/tools/`` and times, on the same inputs: the kernel S1 was before
its redesign split into its sweep alone (its loads after the column's
barriers, as it had them), the same with the loads moved to the
column's start and with them loaded 8 columns ahead, and its one-thread
chase alone; and the redesigned sweep with a five-round shuffle
butterfly in place of each ``__reduce_min_sync``. Every variant must
give the paths and scores of
``viterbi_iteration``.

``--wide`` times S1 past 128 paths at the bench chromosomes' N=55,040
(C=2), inputs drawn on the card (chip_smoke.card_s1_inputs): P=1024
(8 warps), 1025, 2049 and 4096, 4097, 6405, 8193 and 16,385 (the
cluster tier's edges: 5-8 CTAs of 2-17 warps; one CTA of 9-32 warps in
a checkout from before the cluster), and at the widest panel's shape C=1
N=5,506 P=6405; each with its layout and backtrace row as the
checkout's ``sweep_layout`` gives them, and ``group_peak_bytes`` of a
15-iteration group at A=4 per [N, P] cell.

``--ranks`` times clusters of other sizes against each other, in turns
(each size twice, the order reversed the second time): it builds
``csrc/sampling_dp.cu`` with ``-DS1_CLUSTER_RANKS=k`` (the rule's
CTAs a chromosome before the padding is cut) for k = 1, 2, 4 and 16
(8 is the library's own) and drives each with ``sampling.CLUSTER_RANKS``
set to k: at P=6405 (N=55,040 C=2, and C=1 N=5,506) for k = 2, 4, 8 and
16; at P=1025, 2049 and 4096 (N=55,040, C=1 and C=2) for k = 1 (a
cluster of one CTA of 9-32 warps), 2, 4 and 8.

``--beyond`` runs chip_smoke.check_beyond_card with this checkout's
package: one greedy iteration of N=2,300,000 at P=6405 through S1-seg,
its kernels timed by torch.profiler.

Prints one JSON line per checkout (and one for the variants, one each
for ``--wide``, ``--ranks`` and ``--beyond``) with the card's name and
power limit. Exits non-zero without a GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

from fbe_times import cuda_ms, gpu_line

TOOLS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TOOLS)
SHAPE = (2, 55040, 123, 4)  # chip_smoke.MAIN_S1_SHAPE: (C, N, P, A)


def s1_inputs(C, N, P, A, dev):
    """(path_cost, mask, switch) as chip_smoke.check_s1 builds them."""
    import numpy as np
    import torch

    rng = np.random.default_rng(5)
    costs = torch.from_numpy(rng.integers(0, 26, (C, N, A)).astype(np.int32)).to(dev)
    alleles = torch.from_numpy(rng.integers(0, A, (C, N, P))).to(dev)
    path_cost = torch.gather(costs, 2, alleles).to(torch.int32).contiguous()
    mask = torch.from_numpy(rng.random((C, N, P)) > 0.3).to(dev)
    switch = torch.from_numpy(rng.integers(20, 40, (C, N)).astype(np.int32)).to(dev)
    return path_cost, mask, switch


def variants(inputs, want, reps: int) -> dict:
    """Builds tools/s1_split.cu and times its kernels on ``inputs``; each
    must give ``want`` (paths, scores)."""
    import torch

    from pangenie_tpu_torch._build import _nvcc
    from pangenie_tpu_torch.hmm import sampling

    out = os.path.join(ROOT, "build", "tools", "libs1_split.so")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    build = subprocess.run(
        [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", out,
         os.path.join(TOOLS, "s1_split.cu")],
        check=True, capture_output=True, text=True)
    for line in (build.stdout + build.stderr).splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print("  " + line.strip(), file=sys.stderr)
    lib = ctypes.CDLL(out)
    V, I = ctypes.c_void_p, ctypes.c_int
    lib.s1_old_sweep.argtypes = [V] * 6 + [I] * 4 + [V]
    lib.s1_old_chase.argtypes = [V] * 3 + [I] * 3 + [V]
    lib.pg_s1_sweep.argtypes = sampling.S1._argtypes

    path_cost, mask, switch = inputs
    C, N, P = path_cost.shape
    dev = path_cost.device
    stream = torch.cuda.current_stream().cuda_stream
    bt = torch.empty((C, N, P), dtype=torch.int32, device=dev)
    best = torch.empty((C,), dtype=torch.int32, device=dev)
    ends = torch.empty((C,), dtype=torch.int32, device=dev)
    paths = torch.empty((C, N), dtype=torch.int32, device=dev)

    def checked(code):
        if code:
            raise RuntimeError(f"s1_split: CUDA error {code}")

    def old_sweep(variant):
        checked(lib.s1_old_sweep(path_cost.data_ptr(), mask.data_ptr(), switch.data_ptr(),
                                 bt.data_ptr(), best.data_ptr(), ends.data_ptr(), C, N, P,
                                 variant, stream))

    def old_chase():
        checked(lib.s1_old_chase(bt.data_ptr(), ends.data_ptr(), paths.data_ptr(), C, N, P,
                                 stream))

    def shfl_sweep(*args):
        checked(lib.pg_s1_sweep(*args))

    def same(got_paths, got_best, what):
        if not (torch.equal(got_paths, want[0])
                and torch.equal(got_best.to(torch.int64) & sampling.UINT_MAX, want[1])):
            raise AssertionError(f"{what}: paths or scores differ from viterbi_iteration")

    times = {}
    for variant, name in ((0, "old_sweep_ms"), (1, "old_sweep_loads_at_column_start_ms"),
                          (2, "old_sweep_prefetch_ms")):
        old_sweep(variant)
        old_chase()
        same(paths, best, name)
        times[name] = cuda_ms(lambda: old_sweep(variant), reps)
    times["old_chase_ms"] = cuda_ms(old_chase, reps)
    s_bt, s_best, s_ends, _ = sampling.s1_sweep(path_cost, mask, switch, sweep=shfl_sweep,
                                                 stream=stream)
    same(sampling.s1_chase(s_bt, s_ends, P, stream=stream)[0], s_best, "shfl sweep")
    times["shfl_sweep_ms"] = cuda_ms(
        lambda: sampling.s1_sweep(path_cost, mask, switch, sweep=shfl_sweep, stream=stream),
        reps)
    return times


WIDE_SHAPES = [(2, 55040, P) for P in (1024, 1025, 2049, 4096, 4097, 6405, 8193, 16385)] + [
    (1, 5506, 6405)]


def wide(reps: int) -> dict:
    """S1 at WIDE_SHAPES (see the module's docstring)."""
    import torch

    from pangenie_tpu_torch.hmm import bounds, sampling

    sys.path.insert(0, ROOT)
    from chip_smoke import card_s1_inputs

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev)
    g.manual_seed(31)
    record = {}
    for C, N, P in WIDE_SHAPES:
        inputs = card_s1_inputs(g, C, N, P, dev)
        ms = cuda_ms(lambda: sampling.viterbi_iteration(*inputs), reps)
        bt, _best, ends, _ = sampling.s1_sweep(*inputs)[:4]
        record[f"C={C} N={N} P={P}"] = {
            "layout": sampling.sweep_layout(P), "S1_ms": ms,
            "sweep_ms": cuda_ms(lambda: sampling.s1_sweep(*inputs), reps),
            "chase_ms": cuda_ms(lambda: sampling.s1_chase(bt, ends, P), reps),
            "us_per_column": ms * 1e3 / N, "bound_ms": bounds.s1(C, N, P).bound()[0],
            "group_peak_bytes_per_cell": sampling.group_peak_bytes(C, N, P, 4, 15) / (C * N * P)}
        del inputs, bt
        torch.cuda.empty_cache()
    return record


# (C, N, P, S1_CLUSTER_RANKS of the builds timed), each run in turns
RANK_SHAPES = [(2, 55040, 6405, (2, 4, 8, 16)), (1, 5506, 6405, (2, 4, 8, 16))] + [
    (C, 55040, P, (1, 2, 4, 8)) for P in (1025, 2049, 4096) for C in (1, 2)]


def ranks_sweep(reps: int) -> dict:
    """S1 (sweep and chase) per S1_CLUSTER_RANKS build at RANK_SHAPES,
    each timed twice in turns, the order reversed the second time; every
    build must give the rule's paths and best."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from pangenie_tpu_torch import _build
    from pangenie_tpu_torch.hmm import bounds, sampling

    sys.path.insert(0, ROOT)
    from chip_smoke import card_s1_inputs, patched

    sizes_built = sorted({k for *_shape, sizes in RANK_SHAPES for k in sizes})
    sweeps = {k: sampling.S1 if k == sampling.CLUSTER_RANKS else _build.CudaKernel(
        "sampling_dp", "pg_s1_sweep", "s1", sampling.S1._argtypes,
        defines={"S1_CLUSTER_RANKS": k}) for k in sizes_built}
    with ThreadPoolExecutor(len(sweeps)) as pool:  # one nvcc a build, all at once
        list(pool.map(lambda sweep: sweep.lib(), sweeps.values()))
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev)
    g.manual_seed(43)
    record = {}
    for C, N, P, sizes in RANK_SHAPES:
        inputs = card_s1_inputs(g, C, N, P, dev)
        want = sampling.viterbi_iteration(*inputs)

        def iteration(k):
            with patched(sampling, "CLUSTER_RANKS", k):
                bt, best, ends, _ = sampling.s1_sweep(*inputs, sweep=sweeps[k])
                return sampling.s1_chase(bt, ends, P)[0], best

        def layout(k):
            with patched(sampling, "CLUSTER_RANKS", k):
                return sampling.sweep_layout(P)

        times = {k: [] for k in sizes}
        for k in sizes:
            paths, best = iteration(k)
            if not (torch.equal(paths, want[0])
                    and torch.equal(best.to(torch.int64) & sampling.UINT_MAX, want[1])):
                raise AssertionError(f"S1_CLUSTER_RANKS={k} at C={C} N={N} P={P}: "
                                     "paths or best differ")
        for order in (sizes, sizes[::-1]):
            for k in order:
                times[k].append(cuda_ms(lambda: iteration(k), reps))
        record[f"C={C} N={N} P={P}"] = {
            "rule": sampling.sweep_layout(P), "bound_ms": bounds.s1(C, N, P).bound()[0],
            **{f"S1_CLUSTER_RANKS={k}": {"layout": layout(k), "S1_ms": times[k],
                                         "us_per_column": [t * 1e3 / N for t in times[k]]}
               for k in sizes}}
        del inputs, want
        torch.cuda.empty_cache()
    return record


def beyond() -> dict:
    """chip_smoke.check_beyond_card with this checkout's package."""
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke

    t, launches = chip_smoke.check_beyond_card(torch.device("cuda", 0), chip_smoke.gpu_line())
    bound, _by = t["S1_SEG_work"].bound()
    return {"S1_SEG_ms": t["S1_SEG"], "bound_ms": bound, "launches": launches}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--wide", action="store_true")
    ap.add_argument("--ranks", action="store_true")
    ap.add_argument("--beyond", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import torch

    if not torch.cuda.is_available():
        print("no GPU: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from pangenie_tpu_torch.hmm import sampling

    gpu = gpu_line()
    dev = torch.device("cuda", 0)
    C, N, P, A = SHAPE
    inputs = s1_inputs(C, N, P, A, dev)
    want = sampling.viterbi_iteration(*inputs)
    from pangenie_tpu_torch import _build

    for lib, info in _build.build_log.items():  # the register and spill report
        for line in info["report"].splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print(f"  {lib}: {line.strip()}", file=sys.stderr)
    record = {"root": args.root, "shape": {"C": C, "N": N, "P": P},
              "S1_ms": cuda_ms(lambda: sampling.viterbi_iteration(*inputs), args.reps)}
    if hasattr(sampling, "s1_sweep"):
        swept = sampling.s1_sweep(*inputs)  # (bt, best, ends[, carry_out])
        bt, ends = swept[0], swept[2]
        record["sweep_ms"] = cuda_ms(lambda: sampling.s1_sweep(*inputs), args.reps)
        record["chase_ms"] = cuda_ms(lambda: sampling.s1_chase(bt, ends, P), args.reps)
        del bt
    record["S1_us_per_column"] = record["S1_ms"] * 1e3 / N
    if args.variants:
        record.update(variants(inputs, want, args.reps))
    record["gpu"] = gpu
    print(json.dumps(record), flush=True)
    if args.wide:
        print(json.dumps(dict(wide(args.reps), root=args.root, gpu=gpu)), flush=True)
    if args.ranks:
        print(json.dumps(dict(ranks_sweep(args.reps), root=args.root, gpu=gpu)), flush=True)
    if args.beyond:
        print(json.dumps(dict(beyond(), root=args.root, gpu=gpu)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
