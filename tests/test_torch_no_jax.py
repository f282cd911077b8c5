"""The port on a machine without JAX: in a subprocess where importing
``jax`` (or the reference package) fails, import the port's commands,
CLI and forward-backward modules and run a small workload through the
CLI: ``genotype -r -v`` (single), then ``index``, ``genotype -f -w``
and ``vcf``."""

import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import sys
    for name in ("jax", "jaxlib", "pangenie_tpu"):
        sys.modules[name] = None          # any import of them raises
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import pangenie_tpu_torch.commands
    import pangenie_tpu_torch.hmm.fb_generic
    import pangenie_tpu_torch.hmm.fb_kernels
    import pangenie_tpu_torch.kmers.device_counter
    import pangenie_tpu_torch.utils.multiallelic
    from pangenie_tpu_torch import cli
    from pangenie_tpu_torch.utils import simulate as sim

    d = sys.argv[1]
    rng = np.random.default_rng(7)
    reference = sim.random_reference(20_000, rng)
    variants = sim.simulate_panel(reference, nr_samples=4, rng=rng)
    sim.write_inputs(d, reference, variants)
    hap1, hap2 = sim.haplotype_sequences(reference, variants, sample=0)
    sim.simulate_reads(hap1, hap2, coverage=20, read_length=100, rng=rng,
                       outfile=d + "/reads.fa")
    rc = cli.main(["genotype", "-i", d + "/reads.fa", "-r", d + "/ref.fa",
                   "-v", d + "/panel.vcf", "-o", d + "/out", "-x", "3"])
    rc += cli.main(["index", "-r", d + "/ref.fa", "-v", d + "/panel.vcf",
                    "-o", d + "/idx"])
    rc += cli.main(["genotype", "-i", d + "/reads.fa", "-f", d + "/idx",
                    "-o", d + "/staged", "-x", "3", "-w"])
    rc += cli.main(["vcf", "-z", d + "/staged_genotyping.pkl", "-f", d + "/idx",
                    "-o", d + "/staged"])
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "pangenie_tpu")
                    and sys.modules[m] is not None)
    print("RC", rc, "LOADED", loaded)
""")


def test_port_runs_without_jax(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, PANGENIE_TORCH_DEVICE="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT, str(tmp_path)],
        capture_output=True, text=True, env=env, timeout=600, cwd=str(tmp_path),
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "RC 0 LOADED []" in proc.stdout
    with open(tmp_path / "out_genotyping.vcf") as f:
        body = [line for line in f if not line.startswith("#")]
    assert len(body) > 10
    with open(tmp_path / "staged_genotyping.vcf") as f:
        assert [line for line in f if not line.startswith("#")] == body
    assert "forward-backward dispatch: torch_ref" in proc.stderr
