"""Read k-mer counting on one NVIDIA GPU: the host engine's phases beside D1's.

    python3 tools/d1_times.py [--panels sv,bench] [--threads 2] [--no-routes]
                              [--root DIR] [--sweep] [--reps 5]
    python3 tools/d1_times.py --keys [--root DIR] [--seed 7] [--human-keys 700000000]
                              [--queries 40000000] [--reps 5]

Simulates (or reuses) chip_smoke.py's SV panel (20 Mb, 89 paths, one
chromosome) and bench workload (20 Mb, 2 chromosomes, 123 paths), both
with 12x 150 bp reads, under ``build/smoke_inputs/``, and makes (or
reuses) the path-segments FASTA that ``genotype -f`` reads (the SV
panel's index) or that ``single`` writes (the bench workload's, whose
graph table ``single`` then hands to the counter). Then the read k-mer
counting phase of each, as ``commands._read_counter`` runs it, under
both routes in turns: host, D1, D1, host.

- The host route (``ExactKmerCounter.count_file_primed`` with
  ``--threads``, as the commands' -j gives it; 2 in chip_smoke.py's
  runs) split into its parts: (a) the corpus's canonical k-mers
  extracted and ``np.unique``'d (``genotype -f`` only: ``single`` holds
  its table), the count table built from the keys, (b) the read stream
  (``KmerCountTable.stream_update_raw``, the next block parsed on a
  thread meanwhile, as there) and (c) the count export.
- D1 (``kmers/device_counter.py``, through ``_read_counter`` with
  PANGENIE_TORCH_COUNTER=device): the table built on the card or the
  keys moved there, the read stream, the readback
  (``device_counter.last_times``), and its launches.
- Both routes' keys and counts must be equal.

Then both kernels on the first block of the reads (and D1-extract on
the SV corpus's first round) against their plain versions, beside their
bounds and the library calls (``torch.searchsorted`` then
``torch.bincount``) that compute D1-count's function
(``chip_smoke.hold_d1``). ``--no-routes`` skips the two routes.

``--root DIR`` builds DIR's ``pangenie_tpu_torch/csrc/kmer_count.cu``
beside this tree's and times both trees' kernels in turns (other, this,
this, other) on the block of reads and, for the SV panel, the corpus's
first round; every launch is held equal to the plain versions. Where
DIR's ``pg_d1_count`` takes no key count (the entry point of the design
with a fixed directory of min(16, 2k) bits, before the directory
followed the table), it is called so, with that directory: this fork
exists only to time that design beside this one. ``--sweep`` times this
tree's D1-count on the same block with the directory at d = 16-26 bits
and, at the rule's d, built with D1_SCAN = 8 and 16 beside the default
4, each with its table reads (``device_counter.search_steps`` at the
library's ``pg_d1_scan``). Every source is built with nvcc at once, one
process a source.

``--keys`` times the partitioned counter's two kernels instead:
D1-route on the SV block's keys (chip_smoke.check_count_keys's: the
first D1_SLICE_READS SV reads as one block, SENTINEL among the keys)
into 2 and 4 owners beside the torch route it replaced, and
D1-count-keys on owner 0's keys into its partition of the SV table; and
both at a synthetic partition of a human graph's size, one rank's of
four: ``--human-keys`` sorted unique 62-bit keys (cumulative sums of
random gaps, made on the card from ``--seed``) with a directory of 29
bits, and ``--queries`` keys (90% drawn from the table, 10% random) as
the rank receives them from four senders, each sender's run in region
order. At each partition it sweeps the region bits (SWEEP_REGIONS) and
the keys a thread (builds with -DD1_KPT= each of SWEEP_KPT) and
D1-route's CTAs (SWEEP_ROUTE_CTAS beside ``device_counter.route_ctas``'s),
and times D1-route's ROUTE_ABLATIONS (textual cuts) beside it; every
count held equal to count_keys_plain's and every route to
route_plain's; with ``--root DIR`` also DIR's D1-count-keys in turns
with this tree's (other, this, this, other), on the keys in the order
DIR's route sent them (by owner, each owner's in arrival order) and in
region order. It needs build/smoke_inputs/ as chip_smoke.py leaves them
(else it simulates the SV panel, about 4 min).

Prints one JSON line a workload with the card's name and power limit.
Exits non-zero where a check fails, and without a GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

TOOLS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TOOLS)


def host_route(reads: str, segments: str, k: int, keys, threads: int):
    """ExactKmerCounter.count_file_primed's steps, each timed: (keys,
    counts, {part: seconds})."""
    import numpy as np

    from pangenie_tpu_torch.kmers import native
    from pangenie_tpu_torch.kmers.counter import (
        ExactKmerCounter, iter_sequences, try_sequence_blocks)

    parts = {}
    t0 = time.monotonic()
    if keys is None:
        keys = np.unique(ExactKmerCounter._extract_canonical(iter_sequences(segments), k))
    parts["a_extract_unique"] = time.monotonic() - t0
    t0 = time.monotonic()
    table = native.KmerCountTable(keys)
    parts["a_table_build"] = time.monotonic() - t0
    t0 = time.monotonic()
    blocks = iter(try_sequence_blocks(reads))
    with ThreadPoolExecutor(max_workers=1) as parse_pool:
        nxt = parse_pool.submit(next, blocks, None)
        base = 0
        while True:
            block = nxt.result()
            if block is None:
                break
            nxt = parse_pool.submit(next, blocks, None)
            data, offsets = block
            table.stream_update_raw(data, offsets, k, threads, None, base)
            base += len(offsets) - 1
    parts["b_stream"] = time.monotonic() - t0
    t0 = time.monotonic()
    counts = table.export_counts(threads)
    parts["c_export"] = time.monotonic() - t0
    parts["total"] = sum(parts.values())
    return keys, counts, parts


def d1_route(reads: str, segments: str, k: int, keys, threads: int):
    """The phase through ``commands._read_counter`` on the card:
    (counter, wall seconds, D1's parts and launches)."""
    import torch

    from pangenie_tpu_torch import commands
    from pangenie_tpu_torch.kmers import device_counter as dc

    os.environ["PANGENIE_TORCH_COUNTER"] = "device"
    extract, count = dc.D1_EXTRACT.launches, dc.D1_COUNT.launches
    torch.cuda.synchronize()
    t0 = time.monotonic()
    counter = commands._read_counter(reads, segments, k, True, threads, prime_keys=keys,
                                     device=torch.device("cuda", 0))
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    parts = {name: dc.last_times[name] for name in ("prime", "stream", "readback")}
    parts.update(d1_extract_launches=dc.D1_EXTRACT.launches - extract,
                 d1_count_launches=dc.D1_COUNT.launches - count)
    return counter, wall, parts


SWEEP_BITS = (16, 18, 20, 22, 23, 24, 25, 26)
SWEEP_SCANS = (8, 16)
# D1-count's arguments where its source takes no key count (the fixed
# directory of min(16, 2k) bits; --root only)
COUNT_ARGS_FIXED_DIRECTORY = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                              ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                              ctypes.c_void_p]


def compile_variants(out_dir: str, variants: dict) -> dict:
    """Each variant {name: (source text, [-D defines])} built with nvcc
    at once, one process a source, its ptxas report printed; {name:
    (ctypes.CDLL, source text)}."""
    from pangenie_tpu_torch import _build

    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, (text, defines) in variants.items():
        src = os.path.join(out_dir, f"kmer_count_{name}.cu")
        with open(src, "w") as f:
            f.write(text)
        lib = os.path.join(out_dir, f"libkmer_count_{name}.so")
        procs[name] = (lib, text, subprocess.Popen(
            [_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
             *(f"-D{d}" for d in defines), "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (lib, text, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"building the {name} variant failed:\n{log}")
        report = [line.split("ptxas info    : ")[-1].strip() for line in log.splitlines()
                  if "registers" in line or "spill" in line]
        print(json.dumps({"built": name, "ptxas": report}), flush=True)
        out[name] = (ctypes.CDLL(lib), text)
    return out


def build_libraries(out_dir: str, variants: dict) -> dict:
    """Each variant {name: (source text, [-D defines])} built with nvcc
    at once (:func:`compile_variants`); {name: (pg_d1_extract,
    pg_d1_count, its D1_SCAN, or None where D1-count takes no key
    count)}."""
    from pangenie_tpu_torch.kmers import device_counter as dc

    fns = {}
    for name, (cdll, text) in compile_variants(out_dir, variants).items():
        sized = "int n_keys" in text
        extract, count = cdll.pg_d1_extract, cdll.pg_d1_count
        extract.argtypes = dc.D1_EXTRACT._argtypes
        count.argtypes = dc.D1_COUNT._argtypes if sized else COUNT_ARGS_FIXED_DIRECTORY
        extract.restype = count.restype = ctypes.c_int
        fns[name] = (extract, count, cdll.pg_d1_scan() if sized else None)
    return fns


def d1_inputs(reads: str, segments: str, keys, dev):
    """chip_smoke.hold_d1's block of reads and table, and the corpus's
    first round where the table is built on the card: (words, vwords,
    T, table keys, corpus block or None)."""
    import numpy as np

    import chip_smoke
    from pangenie_tpu_torch.kmers import device_counter as dc
    from pangenie_tpu_torch.kmers.counter import iter_sequences

    k = 31
    table_keys = dc.PrimedDeviceCounter(k, keys, corpus_files=[segments], device=dev).table.keys
    data, offsets = dc._joined(list(iter_sequences(
        chip_smoke.d1_slice(reads, chip_smoke.D1_SLICE_READS))))
    words, vwords, n_bases = dc.pack_sequences(data, offsets[:-1], np.diff(offsets))
    corpus = None
    if keys is None:
        w, v, n = next(dc.packed_blocks([segments], k, dc.round_windows(dev)))
        corpus = (dc._on(dev, w), dc._on(dev, v), n)
    return dc._on(dev, words), dc._on(dev, vwords), n_bases, table_keys, corpus


def kernel_times(fns: dict, order, inputs, reps: int, table_bits=None) -> dict:
    """Each of ``order``'s libraries' D1-extract on the block (and the
    corpus round) and D1-count on the block into the table (with the
    directory of ``table_bits``, by default the rule's, where its source
    takes the key count, else of 16), in that order, each held equal to
    the plain versions; {name: {what: ms}} with each name's runs in a
    list."""
    import torch

    import chip_smoke
    from pangenie_tpu_torch import _build
    from pangenie_tpu_torch.kmers import device_counter as dc

    k = 31
    words, vwords, n_bases, table_keys, corpus = inputs
    dev = words.device
    stream = _build.launch_stream(dev)
    tables = {}
    want_keys = {"block": dc.extract_plain(words, vwords, n_bases, k)}
    if corpus is not None:
        want_keys["corpus"] = dc.extract_plain(*corpus, k)
    want_counts = torch.zeros(table_keys.shape, dtype=torch.int32, device=dev)
    dc.count_plain(words, vwords, n_bases, k, dc.make_table(table_keys, k), want_counts)

    def ok(code):
        if code:
            raise RuntimeError(f"a D1 launch returned CUDA error {code}")

    out = {}
    for name in order:
        extract, count, scan = fns[name]
        sized = scan is not None
        d = (table_bits if table_bits is not None else dc.directory_bits(len(table_keys), k)
             ) if sized else 16
        if d not in tables:
            tables[d] = dc.make_table(table_keys, k, d)
        table = tables[d]
        runs = out.setdefault(name, {"d": d})
        blocks = {"block": (words, vwords, n_bases)}
        if corpus is not None:
            blocks["corpus"] = corpus
        for what, (w, v, n) in blocks.items():
            keys = torch.empty(n, dtype=torch.int64, device=dev)

            def run_extract():
                ok(extract(w.data_ptr(), v.data_ptr(), n, k, keys.data_ptr(), stream))

            run_extract()
            torch.cuda.synchronize()
            if not torch.equal(keys, want_keys[what]):
                raise AssertionError(f"{name}: D1-extract's keys on the {what} differ")
            runs.setdefault(f"extract_{what}_ms", []).append(chip_smoke.cuda_ms(run_extract, reps))
        counts = torch.zeros(table_keys.shape, dtype=torch.int32, device=dev)
        head = [words.data_ptr(), vwords.data_ptr(), n_bases, k, table.keys.data_ptr()]
        tail = [table.directory.data_ptr(), table.shift, counts.data_ptr(), stream]
        args = head + ([len(table_keys)] if sized else []) + tail

        def run_count():
            ok(count(*args))

        run_count()
        torch.cuda.synchronize()
        if not torch.equal(counts, want_counts):
            raise AssertionError(f"{name}: D1-count's counts at d={d} differ")
        runs.setdefault("count_ms", []).append(chip_smoke.cuda_ms(run_count, reps))
        runs["table_reads"] = dc.search_steps(table, want_keys["block"], scan) if sized else None
    return out


def against_parent(root: str, inputs, reps: int) -> dict:
    """Both trees' kernels in turns (other, this, this, other)."""
    from pangenie_tpu_torch import _build

    with open(os.path.join(_build.CUDA_SRC_DIR, "kmer_count.cu")) as f:
        this = f.read()
    with open(os.path.join(os.path.abspath(root), "pangenie_tpu_torch", "csrc",
                           "kmer_count.cu")) as f:
        other = f.read()
    fns = build_libraries(os.path.join(ROOT, "build", "tools", "d1_parent"),
                          {"this": (this, []), "other": (other, [])})
    return kernel_times(fns, ["other", "this", "this", "other"], inputs, reps)


def sweep(inputs, reps: int) -> dict:
    """This tree's D1-count at each of SWEEP_BITS, and at the rule's d
    built with each of SWEEP_SCANS."""
    from pangenie_tpu_torch import _build
    from pangenie_tpu_torch.kmers import device_counter as dc

    with open(os.path.join(_build.CUDA_SRC_DIR, "kmer_count.cu")) as f:
        this = f.read()
    fns = build_libraries(os.path.join(ROOT, "build", "tools", "d1_sweep"),
                          {"this": (this, []), **{f"scan{s}": (this, [f"D1_SCAN={s}"])
                                                  for s in SWEEP_SCANS}})
    words, vwords, n_bases, table_keys, _ = inputs
    block = (words, vwords, n_bases, table_keys, None)
    out = {}
    for d in SWEEP_BITS:
        out[f"d{d}"] = kernel_times(fns, ["this"], block, reps, d)["this"]
    rule = dc.directory_bits(len(table_keys), 31)
    for s in SWEEP_SCANS:
        out[f"scan{s}_d{rule}"] = kernel_times(fns, [f"scan{s}"], block, reps)[f"scan{s}"]
    return out


SWEEP_REGIONS = (0, 4, 6, 8, 10, 12)
SWEEP_KPT = (1, 2, 4, 8)
SWEEP_ROUTE_CTAS = (132, 264, 528, 1056, 2048)
# textual cuts of this tree's D1-route, timed beside it (their outputs
# are wrong by design): no scatter pass (what pass 1, the scan and the
# starts cost), and the scatter's stores at each key's own position (what
# the stores' scatter costs)
ROUTE_ABLATIONS = {
    "route_without_scatter": (
        """    if (!code)
        code = launch(d1_route_scatter_kernel, ctas, D1R_THREADS, bin_bytes, stream, keys, m, k,
                      n_ranks, r, ctas, hist, starts, out);
""", ""),
    "route_stores_in_place": (
        "out[at + __popc(peers[j] & below)] = key[j];",
        "out[tile + (warp * D1R_ITEMS + j) * 32 + lane] = key[j];"),
}
# the arguments of a D1-count-keys that takes no segments (its keys in
# any order, one thread a key; --root only)
COUNT_KEYS_ARGS_FLAT = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                        ctypes.c_void_p]


def keys_libraries(root) -> dict:
    """This tree's kmer_count.cu built with each of SWEEP_KPT, its
    ROUTE_ABLATIONS, and ``root``'s where given, all at once: {name:
    (pg_d1_count_keys, takes segments)}, and for the cuts {name:
    (pg_d1_route, None)}."""
    from pangenie_tpu_torch import _build
    from pangenie_tpu_torch.kmers import device_counter as dc

    with open(os.path.join(_build.CUDA_SRC_DIR, "kmer_count.cu")) as f:
        this = f.read()
    variants = {f"kpt{n}": (this, [f"D1_KPT={n}"]) for n in SWEEP_KPT}
    for name, (cut, paste) in ROUTE_ABLATIONS.items():
        if this.count(cut) != 1:
            raise RuntimeError(f"the {name} cut no longer matches csrc/kmer_count.cu")
        variants[name] = (this.replace(cut, paste), [])
    if root:
        with open(os.path.join(os.path.abspath(root), "pangenie_tpu_torch", "csrc",
                               "kmer_count.cu")) as f:
            variants["other"] = (f.read(), [])
    fns = {}
    for name, (lib, text) in compile_variants(
            os.path.join(ROOT, "build", "tools", "d1_keys"), variants).items():
        if name in ROUTE_ABLATIONS:
            route = lib.pg_d1_route
            route.argtypes, route.restype = dc.D1_ROUTE._argtypes, ctypes.c_int
            fns[name] = (route, None)
            continue
        segmented = "seg_v" in text
        count_keys = lib.pg_d1_count_keys
        count_keys.argtypes = dc.D1_COUNT_KEYS._argtypes if segmented else COUNT_KEYS_ARGS_FLAT
        count_keys.restype = ctypes.c_int
        fns[name] = (count_keys, segmented)
    return fns


def received_runs(keys, k: int, n_ranks: int, r: int, senders: int, owner: int):
    """What ``owner`` receives when ``senders`` ranks each route a slice
    of ``keys`` with D1-route: (keys, runs [senders, 2^r])."""
    import torch

    from pangenie_tpu_torch.kmers import device_counter as dc

    parts, runs = [], []
    for chunk in torch.tensor_split(keys, senders):
        binned, sizes = dc.route(chunk.contiguous(), k, n_ranks, r)
        flat = sizes.reshape(-1)
        start = int(flat[:owner << r].sum())
        parts.append(binned[start:start + int(sizes[owner].sum())])
        runs.append(sizes[owner])
    return torch.cat(parts), torch.stack(runs)


def time_partition(fns: dict, name: str, keys_in_order, arrival, k: int, table_keys,
                   n_ranks: int, senders: int, reps: int) -> dict:
    """At one partition: D1-route of ``keys_in_order`` (a block's keys,
    sliced among ``senders``) at each of SWEEP_REGIONS held equal to
    route_plain and timed; owner 0's keys counted by every library at
    each r, held equal to count_keys_plain and timed; the other tree's
    (``fns['other']``) also on ``arrival`` (owner 0's keys as its route
    sent them), in turns."""
    import torch

    import chip_smoke
    from pangenie_tpu_torch.hmm import bounds
    from pangenie_tpu_torch.kmers import device_counter as dc

    dev = keys_in_order.device
    table = dc.make_table(table_keys, k)
    want = torch.zeros(len(table_keys), dtype=torch.int32, device=dev)
    dc.count_keys_plain(arrival, table, want)
    counts = torch.zeros_like(want)
    this = [n for n in fns if n != "other" and n not in ROUTE_ABLATIONS]
    rec = {"partition": f"n={len(table_keys)} keys, d={table.bits}, m={len(arrival)} keys "
                        f"of owner 0 of {n_ranks} from {senders} senders", "route": {},
           "count_keys": {}, "count_keys_bound_ms": None}
    steps = dc.search_steps(table, arrival)
    rec["count_keys_bound_ms"], rec["count_keys_bound_by"] = bounds.d1_count_keys(
        len(arrival), len(table_keys), steps, len(torch.unique(arrival)),
        int((want > 0).sum())).bound()

    def held(launch, what):
        counts.zero_()
        launch()
        torch.cuda.synchronize()
        if not torch.equal(counts, want):
            raise AssertionError(f"{name}: {what} counts differ from count_keys_plain's")
        return chip_smoke.cuda_ms(launch, reps)

    for r in SWEEP_REGIONS:
        if (n_ranks << r) > dc.ROUTE_MAX_BINS:
            continue
        chunk = torch.tensor_split(keys_in_order, senders)[0].contiguous()
        got, sizes = dc.route(chunk, k, n_ranks, r)
        plain = dc.route_plain(chunk, k, n_ranks, r)
        if not (torch.equal(got, plain[0]) and torch.equal(sizes, plain[1])):
            raise AssertionError(f"{name}: D1-route at r={r} differs from route_plain")
        rec["route"][f"r{r}"] = {
            "ms": chip_smoke.cuda_ms(chip_smoke.route_launcher(chunk, k, n_ranks, r), reps),
            "ctas": dc.route_ctas(len(chunk), sizes.numel()),
            "by_ctas": {c: chip_smoke.cuda_ms(chip_smoke.route_launcher(
                chunk, k, n_ranks, r, ctas=c), reps) for c in SWEEP_ROUTE_CTAS},
            **{name: chip_smoke.cuda_ms(chip_smoke.route_launcher(
                chunk, k, n_ranks, r, fn=fns[name][0]), reps) for name in ROUTE_ABLATIONS},
            "m": len(chunk), "bound_ms": bounds.d1_route(len(chunk), len(got),
                                                         sizes.numel()).bound()[0]}
        received, runs = received_runs(keys_in_order, k, n_ranks, r, senders, 0)
        if len(received) != len(arrival):
            raise AssertionError(f"{name}: owner 0 received {len(received)} keys at r={r}")
        for lib in this:
            fn = fns[lib][0]
            rec["count_keys"][f"{lib}_r{r}"] = held(chip_smoke.count_keys_launcher(
                fn, True, received, k, table, counts, runs), f"{lib} at r={r}")
        if "other" in fns:
            lib = f"kpt{dc.D1_COUNT_KEYS.lib().pg_d1_kpt()}"
            fn = fns[lib][0]
            other = fns["other"][0]
            turns = []
            for which in ("other", "this", "this", "other"):
                launch = (chip_smoke.count_keys_launcher(other, False, received, k, table,
                                                         counts, None)
                          if which == "other" else
                          chip_smoke.count_keys_launcher(fn, True, received, k, table, counts,
                                                         runs))
                turns.append({"tree": which, "ms": held(launch, f"{which} at r={r}")})
            rec["count_keys"][f"turns_r{r}_region_order"] = turns
    if "other" in fns:
        other = fns["other"][0]
        rec["count_keys"]["other_arrival_order"] = held(chip_smoke.count_keys_launcher(
            other, False, arrival, k, table, counts, None), "the other tree's, arrival order")
        rec["count_keys"]["this_arrival_order"] = held(chip_smoke.count_keys_launcher(
            fns[f"kpt{dc.D1_COUNT_KEYS.lib().pg_d1_kpt()}"][0], True, arrival, k, table,
            counts, None), "this tree's, arrival order")
    return rec


def sv_partitions(fns: dict, reps: int) -> dict:
    """check_count_keys's partitions: the SV block into 2 and 4 owners,
    owner 0's partition of the SV table; the torch route timed beside
    D1-route."""
    import torch

    import chip_smoke
    from pangenie_tpu_torch import commands
    from pangenie_tpu_torch.kmers import device_counter as dc

    casedir, _ = chip_smoke.timed_inputs(chip_smoke.SV_PANEL)
    prefix = os.path.join(casedir, "index")
    segments = prefix + "_path_segments.fasta"
    if not os.path.exists(segments):
        commands.run_index_command(os.path.join(casedir, "ref.fa"),
                                   os.path.join(casedir, "panel.vcf"), 31, prefix,
                                   nr_jellyfish_threads=2)
    dev = torch.device("cuda", 0)
    words, vwords, n_bases, table_keys, _ = d1_inputs(os.path.join(casedir, "reads.fa"),
                                                      segments, None, dev)
    block = dc.extract(words, vwords, n_bases, 31)
    valid = block[block != dc.SENTINEL]
    out = {}
    for parts in (2, 4):
        by_owner, sizes = chip_smoke.torch_route(valid, parts)
        arrival = by_owner[:int(sizes[0])].contiguous()
        owner_t = dc.owner_of(table_keys, parts)
        rec = time_partition(fns, f"SV into {parts}", block, arrival, 31,
                             table_keys[owner_t == 0].contiguous(), parts, 1, reps)
        rec["torch_route_ms"] = chip_smoke.cuda_ms(lambda: chip_smoke.torch_route(valid, parts),
                                                   reps)
        rec["block"] = f"m={len(block)} keys, {len(valid)} k-mers"
        out[parts] = rec
        print(json.dumps({f"sv_{parts}": rec}), flush=True)
    return out


def human_partition(fns: dict, seed: int, n_keys: int, n_queries: int, reps: int,
                    dev=None) -> dict:
    """The synthetic partition of one rank of four at a human graph's
    size (see the module's doc), its queries from four senders, made on
    ``dev`` (default the card)."""
    import torch

    dev = dev or torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(seed)
    gap = int(1.9 * (1 << 62) / n_keys)
    table_keys = torch.randint(1, gap + 1, (n_keys,), generator=g, device=dev,
                               dtype=torch.int64).cumsum_(0)
    if int(table_keys[-1]) >= 1 << 62:
        raise AssertionError("the synthetic table runs past 62 bits")
    hits = int(0.9 * n_queries)
    queries = torch.cat([
        table_keys[torch.randint(0, n_keys, (hits,), generator=g, device=dev)],
        torch.randint(0, 1 << 62, (n_queries - hits,), generator=g, device=dev,
                      dtype=torch.int64)])
    queries = queries[torch.randperm(n_queries, generator=g, device=dev)].contiguous()
    rec = time_partition(fns, "the synthetic partition", queries, queries, 31, table_keys,
                         1, 4, reps)
    rec["made"] = (f"seed {seed}: {n_keys} keys, cumulative sums of gaps uniform in "
                   f"[1, {gap}]; {n_queries} queries, {hits} drawn from the table")
    print(json.dumps({"human": rec}), flush=True)
    return rec


def keys_mode(args) -> int:
    import torch

    import chip_smoke

    gpu = chip_smoke.gpu_line()
    fns = keys_libraries(args.root)
    record = {"mode": "keys", "gpu": gpu, "sv": sv_partitions(fns, args.reps)}
    torch.cuda.empty_cache()
    record["human"] = human_partition(fns, args.seed, args.human_keys, args.queries, args.reps)
    print(json.dumps(record), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--panels", default="sv,bench")
    ap.add_argument("--threads", type=int, default=2)
    ap.add_argument("--no-routes", action="store_true")
    ap.add_argument("--root", help="another checkout whose D1 is timed beside this one")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--keys", action="store_true",
                    help="time D1-route and D1-count-keys (see the module's doc)")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--human-keys", type=int, default=700_000_000)
    ap.add_argument("--queries", type=int, default=40_000_000)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no GPU: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    if args.keys:
        return keys_mode(args)
    import chip_smoke
    from pangenie_tpu_torch import commands
    from pangenie_tpu_torch.kmers import device_counter as dc
    from pangenie_tpu_torch.kmers.counter import ExactKmerCounter

    gpu = chip_smoke.gpu_line()
    dc.D1_COUNT.lib()
    k = 31
    for name in args.panels.split(","):
        params = {"sv": chip_smoke.SV_PANEL, "bench": chip_smoke.BENCH}[name]
        casedir, simulated = chip_smoke.timed_inputs(params)
        reads = os.path.join(casedir, "reads.fa")
        record = {"panel": name, "params": params, "gpu": gpu, "threads": args.threads,
                  "inputs_s": simulated}
        if name == "sv":
            # the index genotype -f reads; chip_smoke.py leaves one there
            prefix = os.path.join(casedir, "index")
            segments = prefix + "_path_segments.fasta"
            if not os.path.exists(prefix + "_UniqueKmersMap.pkl"):
                t0 = time.monotonic()
                commands.run_index_command(os.path.join(casedir, "ref.fa"),
                                           os.path.join(casedir, "panel.vcf"), k, prefix,
                                           nr_jellyfish_threads=2)
                record["index_s"] = time.monotonic() - t0
            keys = None
        else:
            # single writes its path segments (chip_smoke.py's run leaves
            # them), then counts their k-mers
            segments = os.path.join(casedir, "out_path_segments.fasta")
            if not os.path.exists(segments):
                from pangenie_tpu_torch.panel.builder import PanelBuilder

                PanelBuilder(os.path.join(casedir, "panel.vcf"),
                             os.path.join(casedir, "ref.fa"), segments, k, True)
            t0 = time.monotonic()
            keys = ExactKmerCounter.count_file(segments, k, n_threads=args.threads).keys
            record["graph_count_s"] = time.monotonic() - t0
        record["corpus_bases"] = os.path.getsize(segments)
        runs = []
        want = None
        for route in () if args.no_routes else ("host", "d1", "d1", "host"):
            if route == "host":
                got_keys, got_counts, parts = host_route(reads, segments, k, keys, args.threads)
                wall = parts["total"]
            else:
                counter, wall, parts = d1_route(reads, segments, k, keys, args.threads)
                got_keys, got_counts = counter.keys, counter.counts
            if want is None:
                want = (got_keys, got_counts)
            elif not (np.array_equal(got_keys, want[0]) and np.array_equal(got_counts, want[1])):
                raise AssertionError(f"{name}: the {route} route's table differs from the "
                                     f"host route's")
            runs.append({"route": route, "wall_s": wall, **parts})
            print(f"  {name} {route}: {wall:.2f} s {json.dumps(parts)}", flush=True)
        if runs:
            record.update(runs=runs, n_keys=int(len(want[0])), counted=int(want[1].sum()))
        t = chip_smoke.hold_d1(reads, segments, keys, f"{name} reads", gpu)
        record["kernels"] = {
            key: (t[key] if not isinstance(t[key], dict) else
                  {"shape": t[key]["shape"], "ms": t[key]["ms"],
                   "plain_ms": t[key]["plain_ms"], "bound_ms": t[key]["work"].bound()[0]})
            for key in ("shape", "D1_EXTRACT", "D1_EXTRACT_plain", "D1_COUNT",
                        "D1_COUNT_first", "D1_COUNT_plain", "D1_COUNT_library",
                        "valid_windows", "hits", "corpus") if key in t}
        for key in ("D1_EXTRACT", "D1_COUNT"):
            record["kernels"][key + "_bound_ms"], record["kernels"][key + "_bound_by"] = \
                t[key + "_work"].bound()
            record["kernels"][key + "_us_per_million_windows"] = \
                t[key] * 1e3 / (t[key + "_cols"] / 1e6)
        if args.root or args.sweep:
            inputs = d1_inputs(reads, segments, keys, torch.device("cuda", 0))
            if args.root:
                record["against_parent"] = against_parent(args.root, inputs, args.reps)
            if args.sweep:
                record["sweep"] = sweep(inputs, args.reps)
            del inputs
            torch.cuda.empty_cache()
        print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
