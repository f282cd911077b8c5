"""Times kernels K3/K4 at two of chip_smoke.py's shapes on one NVIDIA GPU.

    python3 tools/fbe_times.py [--root DIR] [--reps 3]

Builds the inputs as chip_smoke.py does (seed 17, K=32, A=16): the SV
path's first chunk (B=1, N=131,072, P=89, with 97/2/1% of the columns
at A=2/4/16) and the batch of bench.py's kernel cell (B=32, N=4096,
P=32, all columns at A=16). Times ``fb_kernels.forward_e`` (K3) and
``backward_e`` (K4) on each with CUDA events, the mean of ``--reps``
launches after a warm-up. ``--root`` imports ``pangenie_tpu_torch`` from
another checkout (default: the one holding this script), so two versions
can be timed in turns on one card. Prints one JSON line per shape, with
the card's name and power limit and the bytes/s achieved (the bytes of
the tensors each kernel takes and returns). Exits non-zero without a
GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

# (B, N, P, K, mixed allele counts)
SHAPES = [(1, 1 << 17, 89, 32, True), (32, 4096, 32, 32, False)]


def gpu_line() -> str:
    return subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True, capture_output=True,
                          text=True, timeout=60).stdout.strip()


def generic_inputs(B, N, P, K, mixed, dev):
    """(E, u, ones, zeros, u_after, is_last) as chip_smoke.check_generic
    builds them: K3 takes (E, u, ones), K4 (alphas, c_fwd, E, u, zeros,
    u_after, is_last, zeros)."""
    import numpy as np
    import torch

    from pangenie_tpu_torch.hmm import fb_generic
    from pangenie_tpu_torch.hmm.forward_backward import columns_from_numpy
    from pangenie_tpu_torch.utils.multiallelic import allele_mix, multiallelic_columns

    caps = allele_mix(N, 17) if mixed else np.full(N, 16, dtype=np.int32)
    cols = columns_from_numpy(
        multiallelic_columns(N, P, K, caps, batch_dims=(B,), seed=17), dev, torch.float32)
    E = fb_generic.bucketed_state_emissions(cols).reshape(B, N, P, P)
    u = fb_generic.factor_trans(cols.trans).contiguous()
    return (E, u, torch.ones((B, P, P), device=dev), torch.zeros((B, P, P), device=dev),
            torch.zeros((B, 3), device=dev), cols.is_last)


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


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import torch

    if not torch.cuda.is_available():
        print("no GPU: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from pangenie_tpu_torch.hmm import fb_kernels

    gpu = gpu_line()
    dev = torch.device("cuda", 0)
    for B, N, P, K, mixed in SHAPES:
        E, u, ones, zeros, u_after, last = generic_inputs(B, N, P, K, mixed, dev)
        alphas, c_fwd = fb_kernels.forward_e(E, u, ones)
        bwd = (alphas, c_fwd, E, u, zeros, u_after, last, zeros)
        posts, beta_out = fb_kernels.backward_e(*bwd)
        k3 = cuda_ms(lambda: fb_kernels.forward_e(E, u, ones), args.reps)
        k4 = cuda_ms(lambda: fb_kernels.backward_e(*bwd), args.reps)
        b3 = nbytes(E, u, ones, alphas, c_fwd)
        b4 = nbytes(*bwd, posts, beta_out)
        print(json.dumps({
            "root": args.root, "shape": {"B": B, "N": N, "P": P},
            "K3_ms": k3, "K4_ms": k4,
            "K3_us_per_column": k3 * 1e3 / N, "K4_us_per_column": k4 * 1e3 / N,
            "K3_GB_per_s": b3 / k3 / 1e6, "K4_GB_per_s": b4 / k4 / 1e6,
            "gpu": gpu,
        }), flush=True)
        del E, u, alphas, c_fwd, bwd, posts, beta_out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
