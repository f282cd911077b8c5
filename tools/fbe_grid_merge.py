"""Times the cross-CTA merge of K3/K4's grid tier alone on one NVIDIA GPU.

    python3 tools/fbe_grid_merge.py [--columns 20000]

Builds ``tools/fbe_grid_merge.cu`` with nvcc into ``build/tools/`` and
times G cooperative CTAs of 1024 threads for G = 8, 33, 66 and 132 (132
is one CTA on every SM of an H100; 66 what each of two chains gets) at P
= 600 and 1025 paths, over ``--columns`` chained columns: the message
written alone (the floor), one bare arrival and wait, the one-hop merge
(every CTA sums all G messages), the two-hop merge (reduce-scatter, a
second arrival, all-gather) and two bare arrivals. The one- and two-hop
merges must leave the same sums. Prints one JSON line per (P, G): us per
column of each, and of each over the floor, with the card's name and
power limit. Exits non-zero without a GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = {0: "floor", 1: "one_arrival", 2: "one_hop", 3: "two_hops", 4: "two_arrivals"}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--columns", type=int, default=20000)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)

    import torch

    if not torch.cuda.is_available():
        print("no GPU: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from chip_smoke import gpu_line
    from pangenie_tpu_torch._build import _nvcc

    out = os.path.join(ROOT, "build", "tools", "libfbe_grid_merge.so")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    build = subprocess.run(
        [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
         "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", out,
         os.path.join(ROOT, "tools", "fbe_grid_merge.cu")],
        capture_output=True, text=True)
    if build.returncode:
        print(build.stdout + build.stderr, file=sys.stderr)
        return 1
    lib = ctypes.CDLL(out)
    lib.merge_run.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 5
    lib.merge_error_string.restype = ctypes.c_char_p
    lib.merge_error_string.argtypes = [ctypes.c_int]
    gpu = gpu_line()
    N = args.columns
    stream = torch.cuda.current_stream().cuda_stream
    dev = torch.device("cuda", 0)
    counter = torch.zeros(1, dtype=torch.int32, device=dev)

    for P in (600, 1025):
        msg = lib.merge_msg_floats(P)
        for G in (8, 33, 66, 132):
            msgs = torch.zeros(2 * G * msg, device=dev)
            sums = torch.zeros(2 * msg, device=dev)
            result = torch.zeros(msg, device=dev)

            def run(mode):
                code = lib.merge_run(mode, G, P, N, msgs.data_ptr(), sums.data_ptr(),
                                     counter.data_ptr(), result.data_ptr(), stream)
                if code:
                    raise RuntimeError(f"merge_run mode {mode} G={G} P={P}: CUDA error "
                                       f"{code} ({lib.merge_error_string(code).decode()})")

            def us_per_column(mode):
                run(mode)
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(3):
                    run(mode)
                end.record()
                torch.cuda.synchronize()
                return start.elapsed_time(end) / 3 * 1e3 / N

            record = {"P": P, "G": G, "columns": N}
            sums_of = {}
            for mode, name in MODES.items():
                record[name + "_us"] = us_per_column(mode)
                sums_of[mode] = result.clone()
            if not torch.equal(sums_of[2], sums_of[3]):
                raise AssertionError(f"P={P} G={G}: the one- and two-hop merges disagree")
            for mode in (1, 2, 3, 4):
                record[MODES[mode] + "_over_floor_us"] = (record[MODES[mode] + "_us"]
                                                          - record["floor_us"])
            record["gpu"] = gpu
            print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
