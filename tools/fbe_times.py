"""Times kernels K3/K4 at chip_smoke.py's shapes on one NVIDIA GPU.

    python3 tools/fbe_times.py [--root DIR] [--reps 3] [--wide] [--ranks] [--ablate] [--grid]

Builds the inputs as chip_smoke.py does (seed 17, K=32, A=16): the SV
path's first chunk (B=1, N=131,072, P=89, with 97/2/1% of the columns
at A=2/4/16) and the batch of bench.py's kernel cell (B=32, N=4096,
P=32, all columns at A=16). Times ``fb_kernels.forward_e`` (K3) and
``backward_e`` (K4) on each with CUDA events, the mean of ``--reps``
launches after a warm-up. ``--root`` imports ``pangenie_tpu_torch`` from
another checkout (default: the one holding this script), so two versions
can be timed in turns on one card. Prints one JSON line per shape, with
the card's name and power limit, the bytes/s achieved (the bytes of the
tensors each kernel takes and returns), us a column and each kernel's
bound (``hmm/bounds.py``). Exits non-zero without a GPU.

``--wide`` times K3/K4 past 128 paths instead, with the 97/2/1% allele
mix: at the chunk shape of chip_smoke.py's ``genotype -f -a 200`` run
(B=11, N=4,941, P=200), at B=2, N=2048, P=200, at chip_smoke.py's B=2,
N=512, P=465, at the cluster tier's edges (B=2, P = 129, 256, 257 at
N=1024 and 471 at N=512), and past it on the grid tier: the chunk shape
of chip_smoke.py's ``genotype -f -a 600`` run (B=2, N=2048, P=600), B=2,
N=512, P=472, and chip_smoke.py's B=1, N=16, P=1025 and B=1, N=64,
P=2049; each line with the layout the checkout's ``generic_launch``
gives (CTAs a chain, threads, shared bytes), on the cluster tier each
kernel's cudaOccupancyMaxActiveClusters reading for that layout, and on
the grid tier its layout and the CTAs the card holds at once.

``--ranks`` (with ``--wide``'s shapes and B=22, N=1024, P=200, a batch
past what the card holds in clusters of 8 at once) times the cluster
tier's sizes against each other, in turns (each build twice, the order
reversed the second time): it builds ``csrc/fb.cu`` with
``-DFBE_CLUSTER_RANKS=k`` for k = 2, 4 and 8 (16 is the library's own),
and with ``-DFBE_SMS=100000`` (the batch never halves the clusters),
all at once, and drives each with ``fb_kernels.CLUSTER_RANKS`` (and
``SMS``) set to match. Each build must give the library's results
(alphas and c_fwd within rtol 2e-4, atol 1e-7). A build whose rule
takes the layout of one already timed (fewer CTAs do not hold a band of
P paths in registers, or the batch halves them) is left out; each line
names the layout it took.

``--grid`` builds ``csrc/fb.cu`` with each GRID_BUILDS define, all at
once, and times the grid tier of each against the library's tier, in
turns (each build twice, the order reversed the second time), at
GRID_SHAPES: with FBE_GRID_ONLY the grid tier in place of the cluster
tier at B=2, N=512, P=465; with FBE_GRID_SMS=1 one CTA a chain (no
arrivals), as the one-CTA tier before the grid tier ran it; with
FBE_GRID_ONE_HOP the merge in one hop, or in two, wherever the rule
would take the other. Each build must give the library's results
(alphas and c_fwd within rtol 2e-4, atol 1e-7); a build whose layout is
the library's is left out.

``--ablate`` builds textual cuts of the cluster tier in csrc/fb.cu
(ABLATIONS, into build/tools/fbe_ablations/, all at once) and times K3
and K4 from each, in turns and back, at the ``-a 200`` chunk shape and at
P=465: what a column costs without the cluster merge, without the E
stream, without the output stream, and with neither stream. A cut
computes another function; only the full source is held to the
library's results.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

# (B, N, P, K, mixed allele counts)
SHAPES = [(1, 1 << 17, 89, 32, True), (32, 4096, 32, 32, False)]
# past 128 paths: genotype -f -a 200's chunk shape in chip_smoke.py's
# large panel, a short batch at P=200, P=465, and the cluster tier's
# edges (its first P, the last of 8 column slots a lane, the first of
# 16, its last, at which the parent's one-CTA tier is timed too)
WIDE_SHAPES = [(11, 4941, 200, 32, True), (2, 2048, 200, 32, True), (2, 512, 465, 32, True)]
EDGE_SHAPES = [(2, 1024, 129, 32, True), (2, 1024, 256, 32, True), (2, 1024, 257, 32, True),
               (2, 512, 471, 32, True)]
# --ranks: the builds (FBE_CLUSTER_RANKS, FBE_SMS; None: the library's
# own) and the shapes they are timed at
RANK_BUILDS = [(2, None), (4, None), (8, None), (16, None), (8, 100_000), (16, 100_000)]
RANK_SHAPES = WIDE_SHAPES + [(22, 1024, 200, 32, True)]
# --ablate: name: [(text in csrc/fb.cu, what replaces it)], each text there once
_FETCHES = [("phases, [&] {\n            if (n + D < N) fetch(n + D, slot);", "phases, [&] {"),
            ("phases, [&] {\n            if (n - D >= 0) fetch(n - D, slot);", "phases, [&] {")]
_STORES = [("if (n > 0 && ok) prev[i] = x * inv;      // alpha_{n-1}", ""),
           ("if (ok) post[i] = a[r][k] * cur * ks.cfs;", ""),
           ("a[r][k] = n > 0 ? (ok ? a_next[i] : 0.f) : cur;", "a[r][k] = cur;")]
ABLATIONS = {
    # the push of the band's message and the wait for the cluster's
    # (the column sums and the total stay those of the step before)
    "no_merge": [("    fbc_push(s, rank, ranks, step & 1);\n"
                  "    fbc_merge(s, c.P, ranks, step & 1, phases);\n", "")],
    # the copies of the E band a ring's depth ahead (the ring keeps the
    # first columns)
    "no_fetch": _FETCHES,
    # K3's alphas and K4's posteriors, and K4's alpha loads
    "no_store": _STORES,
    "no_streams": _FETCHES + _STORES,
}
ABLATE_SHAPES = [WIDE_SHAPES[0], WIDE_SHAPES[2]]
# past the cluster tier: the grid tier at genotype -f -a 600's chunk
# shape, its first P, and chip_smoke.py's shapes of 1025 and 2049 paths
GRID_SHAPES = [(2, 2048, 600, 32, True), (2, 512, 472, 32, True), (1, 16, 1025, 32, True),
               (1, 64, 2049, 32, True)]
# --grid: name: (the build's defines, fb_kernels' settings to match)
GRID_BUILDS = {
    "grid_only": ({"FBE_GRID_ONLY": 1}, {"GRID_ONLY": True}),
    "one_cta": ({"FBE_GRID_SMS": 1}, {"GRID_SMS": 1}),
    "one_hop": ({"FBE_GRID_ONE_HOP": 1 << 30}, {"GRID_ONE_HOP": 1 << 30}),
    "two_hops": ({"FBE_GRID_ONE_HOP": 0}, {"GRID_ONE_HOP": 0}),
}
GRID_SWEEP_SHAPES = [(2, 512, 465, 32, True), (2, 2048, 600, 32, True),
                     (1, 16, 1025, 32, True)]


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


def layout(B, P) -> dict:
    """The checkout's launch for B chains of P paths and, on its cluster
    tier, each kernel's occupancy reading (a checkout from before the
    cluster tier has neither)."""
    from pangenie_tpu_torch.hmm import fb_kernels

    if not hasattr(fb_kernels, "cluster_layout"):
        return {}
    out = {"launch": fb_kernels.generic_launch(P, B)}
    if fb_kernels.cluster_layout(P, B) is not None:
        out["clusters_at_once"] = {name: fb_kernels.cluster_fits(P, B, backward)
                                   for name, backward in (("K3", False), ("K4", True))}
    elif hasattr(fb_kernels, "grid_layout") and P > fb_kernels.MAX_PATHS:
        capacity = fb_kernels.grid_capacity()
        out["grid"] = dict(fb_kernels.grid_layout(P, B, capacity)._asdict(),
                           ctas_at_once=capacity)
    return out


def time_shape(B, N, P, K, mixed, reps) -> dict:
    import torch

    from pangenie_tpu_torch.hmm import bounds, fb_kernels

    dev = torch.device("cuda", 0)
    E, u, ones, zeros, u_after, last = generic_inputs(B, N, P, K, mixed, dev)
    alphas, c_fwd = fb_kernels.forward_e(E, u, ones)
    bwd = (alphas, c_fwd, E, u, zeros, u_after, last, zeros)
    posts, beta_out = fb_kernels.backward_e(*bwd)
    k3 = cuda_ms(lambda: fb_kernels.forward_e(E, u, ones), reps)
    k4 = cuda_ms(lambda: fb_kernels.backward_e(*bwd), reps)
    b3 = nbytes(E, u, ones, alphas, c_fwd)
    b4 = nbytes(*bwd, posts, beta_out)
    record = {
        "shape": {"B": B, "N": N, "P": P}, **layout(B, P),
        "K3_ms": k3, "K4_ms": k4,
        "K3_us_per_column": k3 * 1e3 / N, "K4_us_per_column": k4 * 1e3 / N,
        "K3_bound_ms": bounds.k3(B, N, P).bound()[0],
        "K4_bound_ms": bounds.k4(B, N, P).bound()[0],
        "K3_GB_per_s": b3 / k3 / 1e6, "K4_GB_per_s": b4 / k4 / 1e6,
    }
    del E, u, alphas, c_fwd, bwd, posts, beta_out
    torch.cuda.empty_cache()
    return record


def ranks_sweep(reps: int) -> dict:
    """K3/K4 per RANK_BUILDS build at RANK_SHAPES, each timed twice in
    turns, the order reversed the second time; every build's K3 must
    give the library's alphas and c_fwd."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from pangenie_tpu_torch import _build
    from pangenie_tpu_torch.hmm import fb_kernels

    def defines(k, sms):
        return {"FBE_CLUSTER_RANKS": k, **({"FBE_SMS": sms} if sms else {})}

    builds = {}
    for k, sms in RANK_BUILDS:
        if k == fb_kernels.CLUSTER_RANKS and sms is None:
            builds[(k, sms)] = (fb_kernels.K3, fb_kernels.K4)
        else:
            builds[(k, sms)] = tuple(
                _build.CudaKernel("fb", symbol, "fb", kernel._argtypes, defines=defines(k, sms))
                for symbol, kernel in (("pg_fbe_forward", fb_kernels.K3),
                                       ("pg_fbe_backward", fb_kernels.K4)))
    with ThreadPoolExecutor(len(builds)) as pool:  # one nvcc a build, all at once
        list(pool.map(lambda kernels: kernels[0].lib(), builds.values()))

    saved = (fb_kernels.K3, fb_kernels.K4, fb_kernels.CLUSTER_RANKS, fb_kernels.SMS)

    def use(key):
        k, sms = key
        fb_kernels.K3, fb_kernels.K4 = builds[key]
        fb_kernels.CLUSTER_RANKS = k
        fb_kernels.SMS = sms or saved[3]

    dev = torch.device("cuda", 0)
    record = {}
    try:
        for B, N, P, K, mixed in RANK_SHAPES:
            E, u, ones, zeros, u_after, last = generic_inputs(B, N, P, K, mixed, dev)
            use((saved[2], None))
            want = fb_kernels.forward_e(E, u, ones)
            keys, runs = [], {}
            for key in RANK_BUILDS:
                use(key)
                launch = fb_kernels.generic_launch(P, B)
                if any(runs[o]["launch"] == launch for o in keys):
                    continue                    # the layout of a build already timed
                alphas, c_fwd = fb_kernels.forward_e(E, u, ones)
                torch.testing.assert_close(alphas, want[0], rtol=2e-4, atol=1e-7)
                torch.testing.assert_close(c_fwd, want[1], rtol=2e-4, atol=1e-7)
                keys.append(key)
                runs[key] = {"ranks": launch[0], "launch": launch,
                             "clusters_at_once": fb_kernels.cluster_fits(
                                 P, B, False, kernel=fb_kernels.K3),
                             "K3_ms": [], "K4_ms": []}
                del alphas, c_fwd
            bwd = (want[0], want[1], E, u, zeros, u_after, last, zeros)
            for order in (keys, keys[::-1]):
                for key in order:
                    use(key)
                    runs[key]["K3_ms"].append(
                        cuda_ms(lambda: fb_kernels.forward_e(E, u, ones), reps))
                    runs[key]["K4_ms"].append(cuda_ms(lambda: fb_kernels.backward_e(*bwd), reps))
            record[f"B={B} N={N} P={P}"] = {
                f"FBE_CLUSTER_RANKS={k}" + (f" FBE_SMS={sms}" if sms else ""): dict(
                    runs[(k, sms)],
                    K3_us_per_column=[t * 1e3 / N for t in runs[(k, sms)]["K3_ms"]],
                    K4_us_per_column=[t * 1e3 / N for t in runs[(k, sms)]["K4_ms"]])
                for k, sms in keys}
            del E, u, want, bwd
            torch.cuda.empty_cache()
    finally:
        fb_kernels.K3, fb_kernels.K4, fb_kernels.CLUSTER_RANKS, fb_kernels.SMS = saved
    return record


def grid_sweep(reps: int) -> dict:
    """K3/K4 per GRID_BUILDS build and the library at GRID_SWEEP_SHAPES,
    each timed twice in turns, the order reversed the second time; every
    build's K3 must give the library's alphas and c_fwd."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from pangenie_tpu_torch import _build
    from pangenie_tpu_torch.hmm import fb_kernels

    builds = {"library": ((fb_kernels.K3, fb_kernels.K4), {})}
    for name, (defines, settings) in GRID_BUILDS.items():
        builds[name] = (tuple(
            _build.CudaKernel("fb", symbol, "fb", kernel._argtypes, defines=defines)
            for symbol, kernel in (("pg_fbe_forward", fb_kernels.K3),
                                   ("pg_fbe_backward", fb_kernels.K4))), settings)
    with ThreadPoolExecutor(len(builds)) as pool:  # one nvcc a build, all at once
        list(pool.map(lambda build: build[0][0].lib(), builds.values()))
    names = ("K3", "K4", "GRID_ONLY", "GRID_SMS", "GRID_ONE_HOP")
    saved = {name: getattr(fb_kernels, name) for name in names}

    def use(name):
        for key, value in saved.items():
            setattr(fb_kernels, key, value)
        (k3, k4), settings = builds[name]
        fb_kernels.K3, fb_kernels.K4 = k3, k4
        for key, value in settings.items():
            setattr(fb_kernels, key, value)

    def layout(B, P):
        grid = (fb_kernels.grid_layout(P, B, fb_kernels.grid_capacity())
                if fb_kernels.tier(P, B) == "grid" else None)
        return {"tier": fb_kernels.tier(P, B), "launch": fb_kernels.generic_launch(P, B),
                "grid": grid._asdict() if grid else None}

    dev = torch.device("cuda", 0)
    record = {}
    try:
        for B, N, P, K, mixed in GRID_SWEEP_SHAPES:
            E, u, ones, zeros, u_after, last = generic_inputs(B, N, P, K, mixed, dev)
            use("library")
            want = fb_kernels.forward_e(E, u, ones)
            keys, runs = [], {}
            for name in builds:
                use(name)
                shape_layout = layout(B, P)
                if any(runs[o]["layout"] == shape_layout for o in keys):
                    continue                    # the layout of a build already timed
                alphas, c_fwd = fb_kernels.forward_e(E, u, ones)
                torch.testing.assert_close(alphas, want[0], rtol=2e-4, atol=1e-7)
                torch.testing.assert_close(c_fwd, want[1], rtol=2e-4, atol=1e-7)
                keys.append(name)
                runs[name] = {"layout": shape_layout, "K3_ms": [], "K4_ms": []}
                del alphas, c_fwd
            bwd = (want[0], want[1], E, u, zeros, u_after, last, zeros)
            for order in (keys, keys[::-1]):
                for name in order:
                    use(name)
                    runs[name]["K3_ms"].append(
                        cuda_ms(lambda: fb_kernels.forward_e(E, u, ones), reps))
                    runs[name]["K4_ms"].append(cuda_ms(lambda: fb_kernels.backward_e(*bwd), reps))
            record[f"B={B} N={N} P={P}"] = {
                name: dict(runs[name],
                           K3_us_per_column=[t * 1e3 / N for t in runs[name]["K3_ms"]],
                           K4_us_per_column=[t * 1e3 / N for t in runs[name]["K4_ms"]])
                for name in keys}
            del E, u, want, bwd
            torch.cuda.empty_cache()
    finally:
        for key, value in saved.items():
            setattr(fb_kernels, key, value)
    return record


def ablations(reps: int) -> list:
    """K3/K4's cluster tier from csrc/fb.cu as it is ("full") and from
    each ABLATIONS cut, built with nvcc at once, timed at ABLATE_SHAPES in
    turns and back (the launch the library's rule gives)."""
    import ctypes

    import torch

    from pangenie_tpu_torch import _build
    from pangenie_tpu_torch.hmm import fb_kernels

    out_dir = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "build", "tools", "fbe_ablations")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(_build.CUDA_SRC_DIR, "fb.cu")) as f:
        source = f.read()
    procs = {}
    for name, cuts in [("full", []), *ABLATIONS.items()]:
        text = source
        for old, new in cuts:
            if text.count(old) != 1:
                raise RuntimeError(f"ablation {name}: {old!r} is not in csrc/fb.cu once")
            text = text.replace(old, new)
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
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"building the {name} cut failed:\n{log}")
        so = ctypes.CDLL(lib)
        fns[name] = []
        for symbol, kernel in (("pg_fbe_forward", fb_kernels.K3),
                               ("pg_fbe_backward", fb_kernels.K4)):
            fn = getattr(so, symbol)
            fn.argtypes = kernel._argtypes
            fn.restype = ctypes.c_int
            fns[name].append(fn)

    def checked(fn):
        def call(*args):
            code = fn(*args)
            if code:
                raise RuntimeError(f"launch: CUDA error {code}")
        return call

    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream().cuda_stream
    records = []
    for B, N, P, K, mixed in ABLATE_SHAPES:
        E, u, ones, zeros, u_after, last = generic_inputs(B, N, P, K, mixed, dev)
        last32 = last.to(torch.int32).contiguous()
        want = fb_kernels.forward_e(E, u, ones)
        launch = fb_kernels.generic_launch(P, B)
        alphas = torch.empty_like(E)
        c_fwd = torch.empty((B, N), device=dev)
        posts = torch.empty_like(E)
        beta_out = torch.empty((B, P, P), device=dev)
        null = torch.empty((0,), device=dev)

        def k3(name):
            checked(fns[name][0])(E.data_ptr(), u.data_ptr(), ones.data_ptr(),
                                  alphas.data_ptr(), c_fwd.data_ptr(), null.data_ptr(), B, N,
                                  P, *launch, stream)

        def k4(name):
            checked(fns[name][1])(want[0].data_ptr(), want[1].data_ptr(), E.data_ptr(),
                                  u.data_ptr(), zeros.data_ptr(), u_after.data_ptr(),
                                  last32.data_ptr(), zeros.data_ptr(), posts.data_ptr(),
                                  beta_out.data_ptr(), null.data_ptr(), B, N, P, *launch,
                                  stream)

        k3("full")
        torch.testing.assert_close(alphas, want[0], rtol=2e-4, atol=1e-7)
        record = {"shape": {"B": B, "N": N, "P": P}, "launch": launch}
        for name in [*fns, *reversed(list(fns))]:       # in turns, and back
            for key, fn in (("K3", k3), ("K4", k4)):
                ms = cuda_ms(lambda: fn(name), reps)
                record.setdefault(f"{name}_{key}_us_per_column", []).append(ms * 1e3 / N)
        records.append(record)
        del E, u, want, alphas, posts
        torch.cuda.empty_cache()
    return records


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--wide", action="store_true")
    ap.add_argument("--ranks", action="store_true")
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--grid", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import torch

    if not torch.cuda.is_available():
        print("no GPU: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    gpu = gpu_line()
    if args.ranks:
        print(json.dumps({"ranks": ranks_sweep(args.reps), "root": args.root, "gpu": gpu}),
              flush=True)
        return 0
    if args.grid:
        print(json.dumps({"grid": grid_sweep(args.reps), "root": args.root, "gpu": gpu}),
              flush=True)
        return 0
    if args.ablate:
        for record in ablations(args.reps):
            print(json.dumps({**record, "gpu": gpu}), flush=True)
        return 0
    for shape in WIDE_SHAPES + EDGE_SHAPES + GRID_SHAPES if args.wide else SHAPES:
        print(json.dumps({"root": args.root, **time_shape(*shape, args.reps), "gpu": gpu}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
