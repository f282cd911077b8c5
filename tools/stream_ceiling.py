"""What one CTA can stream through one SM of an NVIDIA GPU, per column.

    python3 tools/stream_ceiling.py [--columns 4096] [--paths 89] [--threads 512,1024]

Builds ``tools/stream_ceiling.cu`` with nvcc into ``build/tools/`` and
times its copy skeleton at one [P, P] float32 column per step (P = 89,
the SV path's, by default), in the shape of kernels K3/K4: a ring of two
slots filled by 16-byte cp.async, a staging column stored by 16-byte
stores, two block barriers per column. Modes: one column loaded, one
stored, one of each (K3's traffic: E in, alpha out), two loaded and one
stored (K4's: E and alpha in, posteriors out), neither (barriers and the
shared-memory copy alone), and a plain global-to-global copy with no
shared memory. One CTA, so one SM, at each thread count of
``--threads`` (K3/K4 launch 512). Then K3's and K4's traffic at 512
threads through the deepest ring that fits beside the staging column
(more bytes in flight: the floor of a one-CTA-per-chain design), and
at ring 2 on two CTAs (does a second SM change the per-CTA rate?).
Prints one JSON line per configuration: us per column and GB/s moved by
that CTA, with the card's name and power limit. Exits non-zero without
a GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RING = 2                      # K3/K4's ring
SMEM_BYTES = 232_448          # shared memory one H100 block can use
# (columns loaded, stored, direct, label, columns moved per step)
MODES = [(1, 0, 0, "load into ring", 1), (0, 1, 0, "store from staging", 1),
         (1, 1, 0, "load + store (K3's traffic)", 2),
         (2, 1, 0, "load 2 + store (K4's traffic)", 3),
         (0, 0, 0, "barriers + shared copy only", 0),
         (0, 0, 1, "global to global, no shared memory", 2)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--columns", type=int, default=4096)
    ap.add_argument("--paths", type=int, default=89)
    ap.add_argument("--threads", default="512,1024", help="comma-separated CTA sizes")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)

    import torch

    if not torch.cuda.is_available():
        print("no GPU: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from pangenie_tpu_torch._build import _nvcc

    out = os.path.join(ROOT, "build", "tools", "libstream_ceiling.so")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    subprocess.run([_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-o", out,
                    os.path.join(ROOT, "tools", "stream_ceiling.cu")], check=True)
    lib = ctypes.CDLL(out)
    lib.stream_run.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    gpu = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True, capture_output=True,
                         text=True, timeout=60).stdout.strip()
    N, P = args.columns, args.paths
    V = -(-P * P // 4)                                    # float4s per column
    stream = torch.cuda.current_stream().cuda_stream
    src = torch.rand(2 * 2 * N * V * 4, device="cuda")   # 2 CTAs x 2 columns a step
    dst = torch.zeros(2 * N * V * 4, device="cuda")

    def run(B, threads, ring, loads, store, direct, label, moved):
        def call():
            code = lib.stream_run(src.data_ptr(), dst.data_ptr(), B, N, V, ring, loads,
                                  store, direct, threads, stream)
            if code:
                raise RuntimeError(f"stream_run: CUDA error {code}")

        call()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        call()
        call()
        end.record()
        torch.cuda.synchronize()
        us = start.elapsed_time(end) / 2 * 1e3 / N
        print(json.dumps({"mode": label, "ctas": B, "threads": threads, "ring": ring,
                          "paths": P, "us_per_column": us,
                          "GB_per_s_per_cta": moved * V * 16 / us / 1e3, "gpu": gpu}),
              flush=True)

    for threads in [int(x) for x in args.threads.split(",") if x]:
        for mode in MODES:
            run(1, threads, RING, *mode)
    for mode in MODES[2:4]:
        loads = mode[0]
        run(1, 512, (SMEM_BYTES // (16 * V) - 1) // loads, *mode)
        run(2, 512, RING, *mode)
    return 0


if __name__ == "__main__":
    sys.exit(main())
