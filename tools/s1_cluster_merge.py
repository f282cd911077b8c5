"""Times the merge chain of S1's cluster sweep alone on one NVIDIA GPU.

    python3 tools/s1_cluster_merge.py [--columns 20000] [--paths 6405]

Builds ``tools/s1_cluster_merge.cu`` with nvcc into ``build/tools/`` and
times one cluster of K CTAs for K = 1, 2, 4, 8 and 16, each CTA of the
ceil(--paths / K / 128) warps of 4 paths a lane that K CTAs need (32 for
one CTA),
over ``--columns`` chained columns: the warps' own reductions alone (the
floor), the one-CTA block merge (K = 1), a cluster barrier merge (every
warp reading the partials through distributed shared memory), and the
push merge of ``csrc/sampling_dp.cu:cluster_col`` (``st.async`` into
every rank's shared memory, each CTA waiting on its own mbarrier).
The barrier and push merges must leave the same result. Prints one JSON
line per (K, warps): us per column of each, and of each merge over the
floor, with the card's name and power limit. Exits non-zero without a
GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = {0: "warps_only", 1: "cta_merge", 2: "cluster_barrier", 3: "st_async_push"}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--columns", type=int, default=20000)
    ap.add_argument("--paths", type=int, default=6405)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)

    import torch

    if not torch.cuda.is_available():
        print("no GPU: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from chip_smoke import gpu_line
    from pangenie_tpu_torch._build import _nvcc

    out = os.path.join(ROOT, "build", "tools", "libs1_cluster_merge.so")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    build = subprocess.run(
        [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
         "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", out,
         os.path.join(ROOT, "tools", "s1_cluster_merge.cu")],
        capture_output=True, text=True)
    if build.returncode:
        print(build.stdout + build.stderr, file=sys.stderr)
        return 1
    lib = ctypes.CDLL(out)
    lib.merge_run.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
    lib.merge_error_string.restype = ctypes.c_char_p
    lib.merge_error_string.argtypes = [ctypes.c_int]
    gpu = gpu_line()
    N = args.columns
    stream = torch.cuda.current_stream().cuda_stream
    result = torch.zeros(1, dtype=torch.int32, device="cuda")

    def run(mode, K, W):
        code = lib.merge_run(mode, K, W, N, 1, result.data_ptr(), stream)
        if code:
            raise RuntimeError(f"merge_run mode {mode} K={K} W={W}: CUDA error {code} "
                               f"({lib.merge_error_string(code).decode()})")

    def us_per_column(mode, K, W):
        run(mode, K, W)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(3):
            run(mode, K, W)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 3 * 1e3 / N

    for K in (1, 2, 4, 8, 16):
        W = min(32, -(-args.paths // (128 * K)))
        modes = (0, 1, 2, 3) if K == 1 else (0, 2, 3)
        record = {"ranks": K, "warps": W, "columns": N}
        results = {}
        for mode in modes:
            record[MODES[mode] + "_us"] = us_per_column(mode, K, W)
            results[mode] = int(result[0])
        if results[2] != results[3] or (K == 1 and results[1] != results[2]):
            raise AssertionError(f"K={K} W={W}: the merges disagree: {results}")
        for mode in modes[1:]:
            record[MODES[mode] + "_over_floor_us"] = (record[MODES[mode] + "_us"]
                                                     - record["warps_only_us"])
        record["gpu"] = gpu
        print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
