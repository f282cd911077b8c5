"""Byte-compares two checkouts' ``sampling -x 15`` outputs on one NVIDIA GPU.

    python3 tools/sampling_parity.py --root DIR [--genotype] [--panels NAME,...]

Simulates chip_smoke.py's large panel (2049 paths, 2 Mb) and widest
panel (6405 paths, 1 Mb) into ``build/smoke_inputs/`` (cached by their
parameters, several processes at once), indexes each once with this
checkout, then runs ``sampling -x 15`` on CUDA over each index with this
checkout and with the one at DIR, each run in its own process, and
compares the panel VCF and every paths TSV byte for byte. Prints one
JSON line per panel (walls, the files compared, whether each is
identical) with the card's name and power limit. Exits non-zero where a
file differs, and without a GPU.

``--genotype`` also genotypes with both checkouts and compares the VCF
bodies (the lines past the ``##`` header, which holds the date):
``genotype -f`` over the large panel's index, ``single -g -p`` on
chip_smoke.py's bench workload (20 Mb, 123 paths) and ``genotype -f -g
-p`` over an index of its SV panel (20 Mb, 89 paths, one chromosome),
both the genotyping and the phasing VCF (kernel V1 at P=16 and 30); and
``genotype -f -a 600`` over an index of its wide-subsets panel (601
paths, 0.2 Mb: K3/K4 past 471 paths), whose body may differ from the
other tree's in float32 rounding where the two take other kernels:
whether it is identical is reported, the lines that differ counted, and
each tree's concordance against the simulated truth must reach 0.98.
``--panels`` keeps only the named panels (large, widest, bench, sv,
wide_subsets): ``--genotype --panels bench,large`` compares only what
runs kernel K1 (``single``, and ``sampling -x 15``, which genotypes at
16 paths), and the large panel's ``genotype -f``.
"""

from __future__ import annotations

import argparse
import filecmp
import glob
import json
import multiprocessing
import os
import subprocess
import sys
import time

TOOLS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TOOLS)

RUN = """import sys
sys.path.insert(0, {root!r})
from pangenie_tpu_torch import commands
commands.{call}
"""


def run(root: str, call: str) -> float:
    """``commands.<call>`` in a new process importing ``root``'s
    package; its wall in seconds."""
    t0 = time.monotonic()
    subprocess.run([sys.executable, "-c", RUN.format(root=root, call=call)], check=True,
                   cwd=ROOT)
    return time.monotonic() - t0


def vcf_body(path: str) -> list:
    with open(path) as f:
        return [line for line in f if not line.startswith("##")]


def index_call(casedir: str, prefix: str) -> str:
    return (f"run_index_command({os.path.join(casedir, 'ref.fa')!r}, "
            f"{os.path.join(casedir, 'panel.vcf')!r}, 31, {prefix!r}, nr_jellyfish_threads=2)")


def compare_genotyping(name: str, casedir: str, call, trees: dict, record: dict,
                       phasing: bool = False) -> bool:
    """``call(out)`` (a commands call writing ``out``_genotyping.vcf and,
    with ``phasing``, ``out``_phasing.vcf) in each tree; whether the VCF
    bodies are identical, and how many lines differ, into ``record``
    (the phasing VCF's under ``<name>_phasing_...``)."""
    kinds = {"genotyping": name, **({"phasing": f"{name}_phasing"} if phasing else {})}
    bodies = {kind: {} for kind in kinds}
    for tree, root in trees.items():
        out = os.path.join(casedir, f"parity_{tree}_{name}")
        record[f"{name}_{tree}_s"] = run(root, call(out))
        for kind in kinds:
            bodies[kind][tree] = vcf_body(f"{out}_{kind}.vcf")
    same = True
    for kind, key in kinds.items():
        ours, theirs = bodies[kind]["change"], bodies[kind]["other"]
        record[f"{key}_variants"] = len(ours) - 1
        record[f"{key}_identical"] = ours == theirs
        record[f"{key}_lines_differing"] = sum(a != b for a, b in zip(ours, theirs)) + abs(
            len(ours) - len(theirs))
        same &= record[f"{key}_identical"]
    return same


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True, help="the other checkout")
    ap.add_argument("--genotype", action="store_true")
    ap.add_argument("--panels", help="a comma-separated subset of the panels")
    args = ap.parse_args()
    trees = {"change": ROOT, "other": os.path.abspath(args.root)}
    sys.path.insert(0, ROOT)

    import torch

    if not torch.cuda.is_available():
        print("no GPU: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    import chip_smoke

    gpu = chip_smoke.gpu_line()
    panels = {"large": chip_smoke.LARGE_PANEL, "widest": chip_smoke.WIDEST_PANEL}
    if args.genotype:
        panels.update(bench=chip_smoke.BENCH, sv=chip_smoke.SV_PANEL,
                      wide_subsets=chip_smoke.WIDE_SUBSET_PANEL)
    if args.panels:
        panels = {name: panels[name] for name in args.panels.split(",")}
    with multiprocessing.get_context("spawn").Pool(len(panels)) as pool:
        made = dict(zip(panels, pool.map(chip_smoke.timed_inputs, panels.values())))
    same_everywhere = True
    for name, (casedir, _seconds) in made.items():
        prefix = os.path.join(casedir, "parity_index")
        reads = os.path.join(casedir, "reads.fa")
        record = {"panel": name, "params": panels[name], "gpu": gpu}
        if name == "bench":
            same_everywhere &= compare_genotyping(
                "single", casedir, lambda out: (
                    f"run_single_command({reads!r}, {os.path.join(casedir, 'ref.fa')!r}, "
                    f"{os.path.join(casedir, 'panel.vcf')!r}, 31, {out!r}, "
                    f"nr_jellyfish_threads=2, nr_core_threads=2, only_genotyping=False, "
                    f"device='cuda')"),
                trees, record, phasing=True)
            print(json.dumps(record), flush=True)
            continue
        record["index_s"] = run(ROOT, index_call(casedir, prefix))
        if name in ("large", "sv") and args.genotype:
            same_everywhere &= compare_genotyping(
                "genotype", casedir, lambda out: (
                    f"run_genotype_command({prefix!r}, {reads!r}, {out!r}, "
                    f"nr_jellyfish_threads=2, nr_core_threads=2, "
                    f"only_genotyping={name != 'sv'}, device='cuda')"),
                trees, record, phasing=name == "sv")
        if name == "sv":
            print(json.dumps(record), flush=True)
            continue
        if name == "wide_subsets":
            from pangenie_tpu_torch.eval.concordance import genotype_concordance

            subsets = chip_smoke.WIDE_SUBSET
            compare_genotyping(
                "subsets", casedir, lambda out: (
                    f"run_genotype_command({prefix!r}, {reads!r}, {out!r}, "
                    f"nr_jellyfish_threads=2, nr_core_threads=2, sampling_size={subsets}, "
                    f"device='cuda')"),
                trees, record)
            for tree in trees:
                record[f"subsets_{tree}_concordance"] = genotype_concordance(
                    os.path.join(casedir, f"parity_{tree}_subsets_genotyping.vcf"),
                    os.path.join(casedir, "truth.vcf")).concordance
                same_everywhere &= record[f"subsets_{tree}_concordance"] >= 0.98
            print(json.dumps(record), flush=True)
            continue
        outs = {}
        for tree, root in trees.items():
            out = os.path.join(casedir, f"parity_{tree}")
            for old in glob.glob(out + "_*"):
                if not os.path.basename(old).startswith(f"parity_{tree}_genotype"):
                    os.remove(old)
            record[f"sampling_{tree}_s"] = run(
                root, f"run_sampling({prefix!r}, {reads!r}, {out!r}, 2, 2, panel_size=15, "
                      f"device='cuda')")
            outs[tree] = sorted(os.path.basename(f)[len(os.path.basename(out)):]
                                for f in glob.glob(out + "_*")
                                if not os.path.basename(f).startswith(f"parity_{tree}_genotype"))
        if outs["change"] != outs["other"]:
            raise AssertionError(f"{name}: the two trees wrote {outs}")
        record["files"] = {
            suffix: filecmp.cmp(os.path.join(casedir, "parity_change" + suffix),
                                os.path.join(casedir, "parity_other" + suffix), shallow=False)
            for suffix in outs["change"]}
        record["identical"] = bool(record["files"]) and all(record["files"].values())
        same_everywhere &= record["identical"]
        print(json.dumps(record), flush=True)
    return 0 if same_everywhere else 1


if __name__ == "__main__":
    sys.exit(main())
