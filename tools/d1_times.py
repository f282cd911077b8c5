"""Read k-mer counting on one NVIDIA GPU: the host engine's phases beside D1's.

    python3 tools/d1_times.py [--panels sv,bench] [--threads 2]

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
(``chip_smoke.hold_d1``). Prints one JSON line a workload with the
card's name and power limit. Exits non-zero where a check fails, and
without a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--panels", default="sv,bench")
    ap.add_argument("--threads", type=int, default=2)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no GPU: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
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
        for route in ("host", "d1", "d1", "host"):
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
        print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
