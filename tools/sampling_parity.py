"""Byte-compares two checkouts' ``sampling -x 15`` outputs on one NVIDIA GPU.

    python3 tools/sampling_parity.py --root DIR

Simulates chip_smoke.py's large panel (2049 paths, 2 Mb) and widest
panel (6405 paths, 1 Mb) into ``build/smoke_inputs/`` (cached by their
parameters, two processes at once), indexes each once with this
checkout, then runs ``sampling -x 15`` on CUDA over each index with this
checkout and with the one at DIR, each run in its own process, and
compares the panel VCF and every paths TSV byte for byte. Prints one
JSON line per panel (walls, the files compared, whether each is
identical) with the card's name and power limit. Exits non-zero where a
file differs, and without a GPU.
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True, help="the other checkout")
    args = ap.parse_args()
    other = os.path.abspath(args.root)
    sys.path.insert(0, ROOT)

    import torch

    if not torch.cuda.is_available():
        print("no GPU: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    import chip_smoke

    gpu = chip_smoke.gpu_line()
    panels = {"large": chip_smoke.LARGE_PANEL, "widest": chip_smoke.WIDEST_PANEL}
    with multiprocessing.get_context("spawn").Pool(2) as pool:
        made = dict(zip(panels, pool.map(chip_smoke.timed_inputs, panels.values())))
    same_everywhere = True
    for name, (casedir, _seconds) in made.items():
        prefix = os.path.join(casedir, "parity_index")
        reads = os.path.join(casedir, "reads.fa")
        record = {"panel": name, "params": panels[name], "gpu": gpu,
                  "index_s": run(ROOT, f"run_index_command({os.path.join(casedir, 'ref.fa')!r}, "
                                       f"{os.path.join(casedir, 'panel.vcf')!r}, 31, "
                                       f"{prefix!r}, nr_jellyfish_threads=2)")}
        outs = {}
        for tree, root in (("change", ROOT), ("other", other)):
            out = os.path.join(casedir, f"parity_{tree}")
            for old in glob.glob(out + "_*"):
                os.remove(old)
            record[f"sampling_{tree}_s"] = run(
                root, f"run_sampling({prefix!r}, {reads!r}, {out!r}, 2, 2, panel_size=15, "
                      f"device='cuda')")
            outs[tree] = sorted(os.path.basename(f)[len(os.path.basename(out)):]
                                for f in glob.glob(out + "_*"))
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
