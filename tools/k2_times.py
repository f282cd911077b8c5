"""Times kernels K2 (the fused backward) and K1 (the fused forward) at chip_smoke.py's
shapes on one NVIDIA GPU.

    python3 tools/k2_times.py [--root DIR] [--reps 3] [--ablate] [--forks] [--sweep]
        [--ablate-k1]

Builds the inputs as chip_smoke.check_fb does (seed 7, synthetic columns
in float32): the bench path's B=2, N=65,536, P=16, K=16 at A=2, A=4 (the
bench run's batches pad A to 4) and A=8, then B=128, N=4096,
P=32 (bench.py's kernel cell), B=2, N=4096, P=16 (every K2 instance
collapses through shared memory) and B=2, N=65,536, P=24 (24 rows a
lane); last the A=4 shape again with the emissions of unequal allele
pairs times 1e-38, so that cells of cur are subnormal, as on real
columns (K1 only). Runs K1 once for K2's alphas and c_fwd, then times
``fb_kernels.backward`` (K2) and ``fb_kernels.forward`` (K1) with CUDA
events, the mean of ``--reps`` launches after a warm-up; where the
library has it, also K1's 256-thread kernel at the same P
(``pg_fb_forward_cta``, the kernel the one-warp tier replaced there,
built from the same source), whose outputs must equal K1's bit for
bit. ``--root`` imports ``pangenie_tpu_torch`` from
another checkout (default: the one holding this script), so two versions
can be timed in turns on one card:

    git archive HEAD pangenie_tpu_torch | tar -x -C build/parent
    python3 tools/k2_times.py --root build/parent; python3 tools/k2_times.py

``--ablate`` builds textual cuts of csrc/fb.cu (ABLATIONS) and times K2
from each at the bench shape at A=2. ``--forks`` builds csrc/fb.cu with
each of the one-warp tier's choices taken away (FORKS) and times K1 and
K2 from each beside the full source where that choice is made: 24 rows
a lane against 32 at P=24. ``--sweep`` times K1 beside its 256-thread
kernel at every P from 1 to 33 (B=2, N=8192, A=2). ``--ablate-k1``
builds csrc/fb.cu with each of K1_ABLATIONS and times K1 from each at
P = 16, 13, 24 and 32 (cuts that change the values change no branch:
the tier has none that depends on them).

Prints one JSON line per shape (and per ``--ablate`` / ``--forks`` run)
with the card's name and power limit, the time a column and the bound
(``hmm/bounds.py``). Exits non-zero without a GPU.
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
# (B, N, P, K, A, tiny): chip_smoke.FB_SHAPES' one-warp shapes, the bench
# shape at A=4 and A=8, P=24, and the A=4 shape with subnormal cells
SHAPES = [(2, 65536, 16, 16, 2, 1.0), (2, 65536, 16, 16, 4, 1.0),
          (2, 65536, 16, 16, 8, 1.0), (128, 4096, 32, 16, 2, 1.0),
          (2, 4096, 16, 16, 2, 1.0), (2, 65536, 24, 16, 2, 1.0),
          (2, 65536, 16, 16, 4, 1e-38)]
# name: (text in csrc/fb.cu, what replaces it, the (B, N, P, K, A) where
# the choice it takes away is made)
FORKS = {
    # K2 takes 32 rows a lane at P = 17..24, as at 25..32 (K1 always does)
    "no_rw24": ("(P <= 24 ? 24 : 32)", "32", (2, 65536, 24, 16, 2)),
}
# name: (text in csrc/fb.cu, what replaces it); each must occur once
ABLATIONS = {
    # the collapse across columns (the column's partials still written)
    "no_collapse": ("post_b[(size_t)m * AA + j] = acc;", ""),
    # the wait for the ring's column and the warp's barrier (its copies
    # still issued)
    "no_wait": ("        cp_async_wait<D - 3>();\n        __syncwarp();\n        if (k > 0)",
                "        if (k > 0)"),
    # the copies of the column D - 1 ahead
    "no_fetch": ("        fetch_next();                                     "
                 "// column n - (D - 1)\n", ""),
    # the helper's row sums over the row's lanes
    "no_row_sums": ("for (int r = 0; r < RW; ++r) R[r] = xor_sum<1, Q>(g[r]);",
                    "for (int r = 0; r < RW; ++r) R[r] = g[r];"),
    # the normalizer's division
    "no_division": ("k.inv = __frcp_rn(s * sc);", "k.inv = s * sc;"),
    # the reads of the next column's inputs out of its slot
    "no_slot_reads": ("        if (AHEAD && n > 0) load((k + 1) % D, y);\n", ""),
}
# K1's one-warp tier with one of its choices taken away; name: (text in
# csrc/fb.cu, what replaces it); each must occur once
K1_ABLATIONS = {
    # the 256-thread kernel's partials read from the staging column at
    # every P, as at P != Q (the same bits)
    "staged": ("const bool aligned = P == Q;", "const bool aligned = false;"),
    # the float division (the same bits, its slow path on subnormal cells)
    "float_division": ("if (s > 0.f && s < 0x1p24f) {", "if (false) {"),
    # the quotient as a float product with the reciprocal (other bits)
    "div_product": ("a[r] = fbf_div(cur[r], sd, inv);", "a[r] = cur[r] * (float)inv;"),
    # no butterflies of the 256-thread kernel's trees (other bits)
    "no_trees": ("for (int w = 0; w < NV; ++w) part[w] += __shfl_xor_sync(FULL_MASK, part[w], o);",
                 "for (int w = 0; w < NV; ++w) part[w] += 0.f;"),
    # no chains of row and column sums (other bits)
    "no_sums": ("        sums[lane] = acc;", "        sums[lane] = 0.f;"),
}


def variant_libraries(cuts: dict, out_dir: str) -> dict:
    """csrc/fb.cu as it is ("full") and with each of ``cuts`` ({name:
    (text, replacement, ...)}), built with nvcc at once, one process a
    source; {name: (its pg_fb_forward, its pg_fb_backward)}."""
    from pangenie_tpu_torch import _build
    from pangenie_tpu_torch.hmm import fb_kernels

    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(_build.CUDA_SRC_DIR, "fb.cu")) as f:
        source = f.read()
    procs = {}
    for name, cut in [("full", None), *cuts.items()]:
        text = source
        if cut is not None:
            if source.count(cut[0]) != 1:
                raise RuntimeError(f"variant {name}: its text is not in csrc/fb.cu once")
            text = source.replace(cut[0], cut[1])
        src = os.path.join(out_dir, f"fb_{name}.cu")
        with open(src, "w") as f:
            f.write(text)
        lib = os.path.join(out_dir, f"libfb_{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-shared", "-Xcompiler", "-fPIC", "-I", _build.CUDA_SRC_DIR,
             "-o", lib, src], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"building the {name} variant failed:\n{out}")
        fns[name] = []
        for symbol, kernel in (("pg_fb_forward", fb_kernels.K1), ("pg_fb_backward",
                                                                 fb_kernels.K2)):
            fn = getattr(ctypes.CDLL(lib), symbol)
            fn.argtypes = kernel._argtypes
            fn.restype = ctypes.c_int
            fns[name].append(fn)
    return fns


def time_variants(fns: dict, shape: tuple, reps: int, gpu: str,
                  kernels=("K2",)) -> dict:
    """``kernels`` (K1, K2) from each of ``fns`` ({name: (pg_fb_forward,
    pg_fb_backward)}) at ``shape`` (B, N, P, K, A), in turns and back."""
    import torch

    from pangenie_tpu_torch.hmm import fb_kernels
    from pangenie_tpu_torch.hmm.forward_backward import allele_emissions, columns_from_numpy
    from pangenie_tpu_torch.utils.synthetic import synthetic_columns

    dev = torch.device("cuda", 0)
    B, N, P, K, A = shape
    cols = columns_from_numpy(
        synthetic_columns(n_columns=N, n_paths=P, n_kmers=K, n_alleles=A,
                          batch_dims=(B,), seed=7, dtype="float32"), dev, torch.float32)
    ea = allele_emissions(cols)
    al = cols.allele_local.to(torch.int32).contiguous()
    last = cols.is_last.to(torch.int32).contiguous()
    a, c = fb_kernels.forward(ea, cols.allele_local, cols.trans)
    want = fb_kernels.backward(a, c, ea, cols.allele_local, cols.trans, cols.is_last)
    posts = torch.empty((B, N, A, A), device=dev)
    alphas = torch.empty_like(a)
    c_fwd = torch.empty_like(c)
    stream = torch.cuda.current_stream().cuda_stream

    def run(fn, kernel):
        if kernel == "K1":
            code = fn(ea.data_ptr(), al.data_ptr(), cols.trans.data_ptr(), alphas.data_ptr(),
                      c_fwd.data_ptr(), B, N, P, A, stream)
        else:
            code = fn(a.data_ptr(), c.data_ptr(), ea.data_ptr(), al.data_ptr(),
                      cols.trans.data_ptr(), last.data_ptr(), posts.data_ptr(), B, N, P, A,
                      stream)
        if code:
            raise RuntimeError(f"{kernel}: CUDA error {code}")

    record = {"shape": {"B": B, "N": N, "P": P, "A": A}, "gpu": gpu}
    for kernel in kernels:
        fn_of = {name: fns[name][kernel == "K2"] for name in fns}
        for name in [*fns, *reversed(list(fns))]:       # in turns, and back
            key = f"{kernel}_{name}"
            record.setdefault(key + "_ms", []).append(
                cuda_ms(lambda: run(fn_of[name], kernel), reps))
            # every variant computes the same function (a cut one need not)
            err = ((alphas - a).abs().max() if kernel == "K1"
                   else (posts - want).abs().max())
            record.setdefault(key + "_max_abs_err", float(err))
    return record


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--forks", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--ablate-k1", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import torch

    if not torch.cuda.is_available():
        print("no GPU: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from pangenie_tpu_torch.hmm import fb_kernels
    from pangenie_tpu_torch.hmm.forward_backward import allele_emissions, columns_from_numpy
    from pangenie_tpu_torch.utils.synthetic import synthetic_columns

    sys.path.insert(0, ROOT)
    from pangenie_tpu_torch.hmm import bounds

    gpu = gpu_line()
    dev = torch.device("cuda", 0)
    cta = getattr(fb_kernels, "K1_CTA", None)          # not in a parent's package
    for B, N, P, K, A, tiny in [] if args.sweep or args.ablate_k1 else SHAPES:
        cols = columns_from_numpy(
            synthetic_columns(n_columns=N, n_paths=P, n_kmers=K, n_alleles=A,
                              batch_dims=(B,), seed=7, dtype="float32"), dev, torch.float32)
        ea = allele_emissions(cols)
        if tiny != 1.0:
            same = torch.eye(A, dtype=torch.bool, device=dev)
            ea = torch.where(same, ea, ea * tiny).contiguous()
        al, tr, last = cols.allele_local, cols.trans, cols.is_last
        a, c = fb_kernels.forward(ea, al, tr)
        record = {"root": args.root, "shape": {"B": B, "N": N, "P": P, "A": A},
                  "tiny": tiny}
        if tiny == 1.0:
            k2 = cuda_ms(lambda: fb_kernels.backward(a, c, ea, al, tr, last), args.reps)
            record.update(K2_ms=k2, K2_us_per_column=k2 * 1e3 / N,
                          K2_bound_ms=bounds.k2(B, N, P, A).bound()[0])
        k1 = cuda_ms(lambda: fb_kernels.forward(ea, al, tr), args.reps)
        record.update(K1_ms=k1, K1_us_per_column=k1 * 1e3 / N,
                      K1_bound_ms=bounds.k1(B, N, P, A).bound()[0])
        if cta is not None:
            k1_cta = cuda_ms(lambda: fb_kernels.forward(ea, al, tr, cta), args.reps)
            a_cta, c_cta = fb_kernels.forward(ea, al, tr, cta)
            record.update(K1_cta_ms=k1_cta, K1_cta_us_per_column=k1_cta * 1e3 / N,
                          K1_equals_cta=bool(torch.equal(a_cta, a) and torch.equal(c_cta, c)))
        record["gpu"] = gpu
        print(json.dumps(record), flush=True)
        del cols, ea, a, c
        torch.cuda.empty_cache()
    if args.sweep:
        sweep = {"gpu": gpu, "B": 2, "N": 8192, "A": 2, "us_per_column": {}}
        for P in range(2, 34):
            rec = time_variants({"full": (fb_kernels.K1, None),
                                 "cta": (cta, None)}, (2, 8192, P, 16, 2), args.reps, gpu,
                                ("K1",))
            sweep["us_per_column"][P] = [round(min(rec[f"K1_{k}_ms"]) * 1e3 / 8192, 4)
                                         for k in ("full", "cta")]
            assert rec["K1_cta_max_abs_err"] == 0.0, (P, rec)
        print(json.dumps(sweep), flush=True)
    if args.ablate_k1:
        fns = variant_libraries(K1_ABLATIONS, os.path.join(ROOT, "build", "tools",
                                                           "k1_ablations"))
        for P in (16, 13, 24, 32):
            print(json.dumps(time_variants(fns, (2, 8192, P, 16, 2), args.reps, gpu,
                                           ("K1",))), flush=True)
    if args.ablate:
        fns = variant_libraries(ABLATIONS, os.path.join(ROOT, "build", "tools",
                                                        "k2_ablations"))
        print(json.dumps(time_variants(fns, SHAPES[0][:5], args.reps, gpu)), flush=True)
    if args.forks:
        fns = variant_libraries({k: v[:2] for k, v in FORKS.items()},
                                os.path.join(ROOT, "build", "tools", "k2_forks"))
        for name, (_text, _by, shape) in FORKS.items():
            record = time_variants({k: fns[k] for k in ("full", name)}, shape, args.reps,
                                   gpu, ("K1", "K2"))
            print(json.dumps(dict(record, fork=name)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
