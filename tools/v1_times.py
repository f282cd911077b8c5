"""Times kernel V1 (the phasing Viterbi, csrc/viterbi.cu) on one NVIDIA GPU.

    python3 tools/v1_times.py [--reps 3] [--ablate]

Shapes (B, N, P, A), synthetic columns in float32 (seed 7) through
``viterbi.viterbi_inputs``: the bench run's phasing batch shape B=2
N=65,536 P=16 A=4, the phasing cell of docs/BENCHMARKS.md B=2 N=65,536
P=30 A=8, and a chromosome of the SV panel's length B=1 N=262,144 P=30
A=16. Times ``v1_kernels.sweep`` (V1 with backtraces and the chase)
and V1 without backtraces (the forward pass of the checkpointed form)
with CUDA events, the mean of ``--reps`` launches after a warm-up, beside
the bound (``hmm/bounds.py``).

``--ablate`` builds textual cuts of csrc/viterbi.cu (ABLATIONS) with nvcc
at once and times V1 from each at the first two shapes, in turns and
back: what a cut takes away of a column's time. Cuts change the values,
so their outputs are not checked.

Prints one JSON line per shape (and per ablated shape) with the card's
name and power limit. Exits non-zero without a GPU.
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
sys.path.insert(0, ROOT)
SHAPES = [(2, 65536, 16, 4), (2, 65536, 30, 8), (1, 262144, 30, 16)]
# name: (text in csrc/viterbi.cu, what replaces it); each must occur once
ABLATIONS = {
    # the row and column top-2 passes cut to one element
    "no_row_col_pass": ("for (int j = 0; j < P; ++j) {\n                    row.add(",
                        "for (int j = 0; j < 1; ++j) {\n                    row.add("),
    # the switch-both pass cut to one element
    "no_g_pass": ("for (int j = 0; j < P; ++j) g.add(", "for (int j = 0; j < 1; ++j) g.add("),
    # the sum of exp in float (__expf) instead of double exp
    "float_exp": ("sum += exp((double)cur[r] - md);", "sum += __expf(cur[r] - mx);"),
    # no logsumexp at all (every column uniform)
    "no_lse": ("if (mx > -INFINITY) {", "if (false) {"),
    # no backtrace stores
    "no_bt_stores": ("if (bt_n && (valid >> r & 1)) bt_n", "if (false) bt_n"),
    # no chase
    "no_chase": ("    if (!bt) return;", "    return;"),
}


def variant_libraries(out_dir: str) -> dict:
    """csrc/viterbi.cu as it is ("full") and with each of ABLATIONS, built
    with nvcc at once, one process a source; {name: its pg_v1_viterbi}."""
    from pangenie_tpu_torch import _build
    from pangenie_tpu_torch.hmm import v1_kernels

    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(_build.CUDA_SRC_DIR, "viterbi.cu")) as f:
        source = f.read()
    procs = {}
    for name, cut in [("full", None), *ABLATIONS.items()]:
        text = source
        if cut is not None:
            if source.count(cut[0]) != 1:
                raise RuntimeError(f"variant {name}: its text is not in csrc/viterbi.cu once")
            text = source.replace(cut[0], cut[1])
        src = os.path.join(out_dir, f"viterbi_{name}.cu")
        with open(src, "w") as f:
            f.write(text)
        lib = os.path.join(out_dir, f"libviterbi_{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-shared", "-Xcompiler", "-fPIC", "-I", _build.CUDA_SRC_DIR,
             "-o", lib, src], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"building the {name} variant failed:\n{out}")
        fn = ctypes.CDLL(lib).pg_v1_viterbi
        fn.argtypes = v1_kernels.V1._argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def inputs_of(shape, dev):
    """V1's checked inputs, entry carry and first flags at ``shape``."""
    import torch

    from pangenie_tpu_torch.hmm import v1_kernels, viterbi
    from pangenie_tpu_torch.hmm.forward_backward import columns_from_numpy
    from pangenie_tpu_torch.utils.synthetic import synthetic_columns

    B, N, P, A = shape
    cols = columns_from_numpy(
        synthetic_columns(n_columns=N, n_paths=P, n_kmers=16, n_alleles=A, batch_dims=(B,),
                          seed=7, dtype="float32"), dev, torch.float32)
    inputs = viterbi.viterbi_inputs(cols)
    carry = torch.zeros((B, P * P), dtype=torch.float32, device=dev)
    first = torch.ones((B,), dtype=torch.bool, device=dev)
    return v1_kernels.checked_inputs(inputs, carry, first)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--ablate", action="store_true")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("no GPU: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from pangenie_tpu_torch.hmm import bounds, v1_kernels

    gpu = gpu_line()
    dev = torch.device("cuda", 0)
    for shape in SHAPES:
        B, N, P, A = shape
        inputs, carry, first = inputs_of(shape, dev)
        full = cuda_ms(lambda: v1_kernels.launch(inputs, carry, first), args.reps)
        forward = cuda_ms(lambda: v1_kernels.launch(inputs, carry, first, backtrace=False),
                          args.reps)
        bound, by = bounds.v1(B, N, P, A).bound()
        print(json.dumps({"shape": {"B": B, "N": N, "P": P, "A": A}, "V1_ms": full,
                          "V1_us_per_column": full * 1e3 / N, "V1_forward_ms": forward,
                          "V1_forward_us_per_column": forward * 1e3 / N, "bound_ms": bound,
                          "bound_by": by, "gpu": gpu}), flush=True)
        del inputs, carry, first
        torch.cuda.empty_cache()
    if args.ablate:
        fns = variant_libraries(os.path.join(ROOT, "build", "tools", "v1_ablations"))
        for shape in SHAPES[:2]:
            inputs, carry, first = inputs_of(shape, dev)
            record = {"shape": dict(zip("BNPA", shape)), "gpu": gpu}
            for name in [*fns, *reversed(list(fns))]:      # in turns, and back
                # the wrapper's outputs, allocated once; the variant launched on them
                launch_args = []
                keep = v1_kernels.launch(inputs, carry, first,
                                         kernel=lambda *a: launch_args.extend(a))

                def run():
                    code = fns[name](*launch_args)
                    if code:
                        raise RuntimeError(f"{name}: CUDA error {code}")

                record.setdefault(f"{name}_us_per_column", []).append(
                    cuda_ms(run, args.reps) * 1e3 / shape[1])
                del keep
            print(json.dumps(record), flush=True)
            del inputs, carry, first
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
