"""Times kernel K4 against an ablation that stages alpha in its E ring.

    python3 tools/k4_alpha_ring.py [--reps 3]

K4 (``csrc/fb.cu``) loads alpha_n from global memory into registers a
column ahead; ``tools/k4_alpha_ring.cu`` instead copies it by 16-byte
cp.async into each ring slot beside E, with K4's arithmetic otherwise
unchanged. This script builds the ablation with nvcc into
``build/tools/`` (printing its register and spill report), runs both on
the SV path's first chunk as ``tools/fbe_times.py`` builds it (B=1,
N=131,072, P=89), requires the same bits from both, and times them in
turns with CUDA events (the mean of ``--reps`` launches after a warm-up,
K4 / ablation / K4 / ablation). Prints one JSON line with the card's
name and power limit. Exits non-zero without a GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

TOOLS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TOOLS)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)

    import torch

    if not torch.cuda.is_available():
        print("no GPU: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from fbe_times import SHAPES, cuda_ms, generic_inputs, gpu_line
    from pangenie_tpu_torch._build import _nvcc
    from pangenie_tpu_torch.hmm import fb_kernels

    out = os.path.join(ROOT, "build", "tools", "libk4_alpha_ring.so")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    build = subprocess.run(
        [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", out,
         os.path.join(TOOLS, "k4_alpha_ring.cu")],
        check=True, capture_output=True, text=True)
    for line in (build.stdout + build.stderr).splitlines():
        if "alpha_ring_kernel" in line or "registers" in line or "spill" in line:
            print("  " + line.strip())
    lib = ctypes.CDLL(out)
    lib.k4_alpha_ring.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3 + [ctypes.c_void_p]

    gpu = gpu_line()
    dev = torch.device("cuda", 0)
    B, N, P, K, mixed = SHAPES[0]
    E, u, ones, zeros, u_after, last = generic_inputs(B, N, P, K, mixed, dev)
    alphas, c_fwd = fb_kernels.forward_e(E, u, ones)
    last = last.to(torch.int32).contiguous()
    bwd = (alphas, c_fwd, E, u, zeros, u_after, last, zeros)
    stream = torch.cuda.current_stream().cuda_stream

    def ablation():
        posts = torch.empty_like(alphas)
        beta_out = torch.empty_like(zeros)
        code = lib.k4_alpha_ring(*[x.data_ptr() for x in bwd], posts.data_ptr(),
                                 beta_out.data_ptr(), B, N, P, stream)
        if code:
            raise RuntimeError(f"k4_alpha_ring: CUDA error {code}")
        return posts, beta_out

    want = fb_kernels.backward_e(*bwd)
    got = ablation()
    torch.cuda.synchronize()
    same = all(torch.equal(g, w) for g, w in zip(got, want))
    del got, want
    if not same:
        raise AssertionError("the ablation's posteriors differ from K4's")
    k4, ring = [], []
    for _ in range(2):
        k4.append(cuda_ms(lambda: fb_kernels.backward_e(*bwd), args.reps))
        ring.append(cuda_ms(ablation, args.reps))
    print(json.dumps({
        "shape": {"B": B, "N": N, "P": P}, "bit_identical": same,
        "K4_ms": k4, "alpha_in_ring_ms": ring,
        "K4_us_per_column": sum(k4) / len(k4) * 1e3 / N,
        "alpha_in_ring_us_per_column": sum(ring) / len(ring) * 1e3 / N,
        "gpu": gpu,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
