"""Times kernel V1 (the phasing Viterbi, csrc/viterbi.cu) on one NVIDIA GPU.

    python3 tools/v1_times.py [--reps 3] [--root DIR] [--warps] [--ablate]

Shapes (B, N, P, A), synthetic columns in float32 (seed 7) through
``viterbi.viterbi_inputs``: the bench run's phasing batch shape B=2
N=65,536 P=16 A=4, the phasing cell of docs/BENCHMARKS.md B=2 N=65,536
P=30 A=8, and a chromosome of the SV panel's length B=1 N=262,144 P=30
A=16. Times ``v1_kernels.sweep`` (V1 with backtraces and the chase)
and V1 without backtraces (the forward pass of the checkpointed form)
with CUDA events, the mean of ``--reps`` launches after a warm-up, beside
the bound (``hmm/bounds.py``).

``--root DIR`` builds DIR's ``pangenie_tpu_torch/csrc/viterbi.cu`` (another
checkout, such as the parent commit unpacked with ``git archive``) and
times it beside this tree's at every shape, in turns (this, other,
other, this), both with backtraces and the chase; the two must give the
same states and exit carry bits.

``--warps`` builds this tree's source with ``-DV1_WARPS=w`` (every Q on
w warps a chain) for w = 1, 2, 4, 8, 16 and times each at B=2 N=16,384
and P = 4, 8, 16, 24, 30 (A=8; 4 at P=4), in turns and back; each must give the
first's outputs. The table sets ``v1_warps``'s rule.

``--ablate`` builds textual cuts of csrc/viterbi.cu (ABLATIONS) and times
V1's forward pass (no backtraces, no chase: a cut's backtraces may lead
anywhere) from each at the first two shapes, in turns and back: what a
cut takes away of a column's time. Cuts change the values, so their
outputs are not checked.

Every variant is built with nvcc at once, one process a source. Prints
one JSON line per shape (and per variant table) with the card's name
and power limit. Exits non-zero without a GPU.
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
WARP_SHAPES = [(2, 16384, 4, 4), (2, 16384, 8, 8), (2, 16384, 16, 8), (2, 16384, 24, 8),
               (2, 16384, 30, 8)]
WARPS = (1, 2, 4, 8, 16)
# name: the (text in csrc/viterbi.cu, what replaces it) pairs of a cut;
# each text must occur once
ABLATIONS = {
    # every merge tree inside a thread cut to its first entry (rows,
    # columns, switch both)
    "one_element": [("for (int h = 1; h < E; h *= 2)", "for (int h = E; h < E; h *= 2)")],
    # the exps in float (__expf) instead of double exp
    "float_exp": [("sum += exp((double)cur[r] - md);", "sum += (double)__expf(cur[r] - mx);")],
    # the cross-warp reductions removed: each thread takes its own warp's
    # column partial, maximum and sum only (the barriers stay)
    "no_cross_warp": [
        ("for (int h = 1; h < W; h *= 2)", "for (int h = W; h < W; h *= 2)"),
        ("for (int i = 1; i < W; ++i) mx = fmaxf(mx, wmax[i]);", ""),
        ("for (int i = 1; i < W; ++i) total += wsum[i];", ""),
        ("col = w[0];", "col = w[warp];"),
    ],
    # the merges across lanes removed: the row and switch-both folds'
    # G lanes, the column's lanes in a warp
    "no_lane_merges": [
        ("for (int o = 1; o < G; o *= 2) rs = v1_merge_lane(rs, o);", ""),
        ("for (int o = 1; o < G; o *= 2) g = v1_merge_lane(g, o);", ""),
        ("for (int o = Q; o < 32; o *= 2) c = v1_merge_lane(c, o);", ""),
    ],
    # the logsumexp cut to its max: no exp, no double sum, no log (the
    # columns stay apart, each shifted by its max; the barriers stay)
    "max_only": [("if (mx > -INFINITY) {\n            const double md = mx;",
                  "if (false) {\n            const double md = mx;"),
                 ("lse = (float)(log(total) + (double)mx);", "lse = mx;")],
}


def build_libraries(out_dir: str, variants: dict) -> dict:
    """Each variant {name: (source text, include dir, [-D defines])}
    built with nvcc at once, one process a source; {name: its
    pg_v1_viterbi}."""
    from pangenie_tpu_torch import _build
    from pangenie_tpu_torch.hmm import v1_kernels

    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, (text, include, defines) in variants.items():
        src = os.path.join(out_dir, f"viterbi_{name}.cu")
        with open(src, "w") as f:
            f.write(text)
        lib = os.path.join(out_dir, f"libviterbi_{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", include,
             *(f"-D{d}" for d in defines), "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"building the {name} variant failed:\n{out}")
        # each instance's registers and spills (ptxas -v), this tree's in full
        report = [line.split("ptxas info    : ")[-1].strip() for line in out.splitlines()
                  if "registers" in line or ("spill" in line and (
                      name == "this" or not line.strip().startswith("0 bytes")))]
        print(json.dumps({"built": name, "ptxas": report if name == "this" else
                          [line for line in report if "spill" in line]}), flush=True)
        fn = ctypes.CDLL(lib).pg_v1_viterbi
        fn.argtypes = v1_kernels.V1._argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def this_source() -> str:
    from pangenie_tpu_torch import _build

    with open(os.path.join(_build.CUDA_SRC_DIR, "viterbi.cu")) as f:
        return f.read()


def cut(source: str, name: str, pairs) -> str:
    for old, new in pairs:
        if source.count(old) != 1:
            raise RuntimeError(f"variant {name}: {old!r} is not in csrc/viterbi.cu once")
        source = source.replace(old, new)
    return source


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


def raw_launch(fn, inputs, carry, first, backtrace=True):
    """(run, outputs): ``run()`` launches entry point ``fn`` on the
    wrapper's outputs for ``inputs``, allocated once."""
    from pangenie_tpu_torch.hmm import v1_kernels

    launch_args = []
    out = v1_kernels.launch(inputs, carry, first, backtrace=backtrace,
                            kernel=lambda *a: launch_args.extend(a))

    def run():
        code = fn(*launch_args)
        if code:
            raise RuntimeError(f"CUDA error {code}")
    return run, out


def in_turns(fns: dict, shape, dev, reps: int, check: bool = True) -> dict:
    """Each of ``fns`` timed at ``shape`` in turns and back (us a
    column, both readings); with ``check`` each one's states and exit
    carry bits against the first's, else the forward pass alone."""
    import torch

    inputs, carry, first = inputs_of(shape, dev)
    runs = {name: raw_launch(fn, inputs, carry, first, backtrace=check)
            for name, fn in fns.items()}
    record = {"shape": dict(zip("BNPA", shape))}
    for name in [*runs, *reversed(list(runs))]:
        record.setdefault(f"{name}_us_per_column", []).append(
            cuda_ms(runs[name][0], reps) * 1e3 / shape[1])
    if check:
        names = list(runs)
        ref = runs[names[0]][1]
        for name in names[1:]:
            out = runs[name][1]
            record[f"{name}_same_outputs"] = bool(
                torch.equal(out.states, ref.states)
                and torch.equal(out.carry.view(torch.int32), ref.carry.view(torch.int32)))
    del runs, inputs, carry, first
    torch.cuda.empty_cache()
    return record


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--root", help="another checkout whose V1 is timed beside this one")
    ap.add_argument("--warps", action="store_true")
    ap.add_argument("--ablate", action="store_true")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("no GPU: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from pangenie_tpu_torch import _build
    from pangenie_tpu_torch.hmm import bounds, v1_kernels

    gpu = gpu_line()
    dev = torch.device("cuda", 0)
    source = this_source()
    variants = {"this": (source, _build.CUDA_SRC_DIR, [])}
    if args.root:
        other = os.path.join(os.path.abspath(args.root), "pangenie_tpu_torch", "csrc")
        with open(os.path.join(other, "viterbi.cu")) as f:
            variants["other"] = (f.read(), other, [])
    if args.warps:
        variants.update({f"w{w}": (source, _build.CUDA_SRC_DIR, [f"V1_WARPS={w}"])
                         for w in WARPS})
    if args.ablate:
        variants.update({name: (cut(source, name, pairs), _build.CUDA_SRC_DIR, [])
                         for name, pairs in ABLATIONS.items()})
    fns = build_libraries(os.path.join(ROOT, "build", "tools", "v1_variants"), variants)

    for shape in SHAPES:
        B, N, P, A = shape
        inputs, carry, first = inputs_of(shape, dev)
        full = cuda_ms(lambda: v1_kernels.launch(inputs, carry, first), args.reps)
        forward = cuda_ms(lambda: v1_kernels.launch(inputs, carry, first, backtrace=False),
                          args.reps)
        bound, by = bounds.v1(B, N, P, A).bound()
        print(json.dumps({"shape": {"B": B, "N": N, "P": P, "A": A},
                          "warps": v1_kernels.warps(P), "V1_ms": full,
                          "V1_us_per_column": full * 1e3 / N, "V1_forward_ms": forward,
                          "V1_forward_us_per_column": forward * 1e3 / N, "bound_ms": bound,
                          "bound_by": by, "gpu": gpu}), flush=True)
        del inputs, carry, first
        torch.cuda.empty_cache()
        if args.root:
            record = in_turns({k: fns[k] for k in ("this", "other")}, shape, dev, args.reps)
            this, other = (sum(record[f"{k}_us_per_column"]) / 2 for k in ("this", "other"))
            record.update(kind="against the other tree", speedup=other / this, gpu=gpu)
            print(json.dumps(record), flush=True)
    if args.warps:
        for shape in WARP_SHAPES:
            record = in_turns({f"w{w}": fns[f"w{w}"] for w in WARPS}, shape, dev, args.reps)
            record.update(kind="warps a chain", rule=v1_kernels.warps(shape[2]), gpu=gpu)
            print(json.dumps(record), flush=True)
    if args.ablate:
        for shape in SHAPES[:2]:
            record = in_turns({"full": fns["this"], **{k: fns[k] for k in ABLATIONS}}, shape,
                              dev, args.reps, check=False)
            record.update(kind="cuts, forward pass", gpu=gpu)
            print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
