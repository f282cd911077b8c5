"""The port's ``concordance`` subcommand prints the reference package's
stdout byte for byte (``pangenie_tpu/cli.py:199-210``) on a simulated
called/truth VCF pair: the truth a panel's first sample, the calls that
sample's genotypes with some records swapped for another sample's, some
no-calls and some records missing."""

import numpy as np

from pangenie_tpu import cli as jax_cli
from pangenie_tpu_torch import cli
from pangenie_tpu_torch.utils import simulate as sim


def _pair(d):
    rng = np.random.default_rng(31)
    reference = sim.random_reference(30_000, rng)
    variants = sim.simulate_panel(reference, nr_samples=4, rng=rng, sv_fraction=0.1)
    sim.write_inputs(str(d), reference, variants)
    truth = d / "panel.vcf"
    called = d / "called.vcf"
    with open(truth) as src, open(called, "w") as out:
        for line in src:
            if line.startswith("#"):
                out.write(line)
                continue
            fields = line.rstrip("\n").split("\t")
            draw = rng.random()
            if draw < 0.05:
                continue                      # missing from the call set
            if draw < 0.12:
                fields[9] = "./."             # a no-call
            elif draw < 0.3:
                fields[9] = fields[10].replace("|", "/")   # another sample's genotype
            out.write("\t".join(fields[:10]) + "\n")
    return str(called), str(truth)


def test_concordance_prints_the_references_stdout(tmp_path, capsys):
    called, truth = _pair(tmp_path)
    assert jax_cli.main(["concordance", "-c", called, "-t", truth]) == 0
    want = capsys.readouterr().out
    assert cli.main(["concordance", "-c", called, "-t", truth]) == 0
    got = capsys.readouterr().out
    assert got == want
    lines = dict(line.split("\t") for line in got.splitlines())
    assert int(lines["total"]) > 50 and 0 < float(lines["concordance"]) < 1
    assert int(lines["no_call"]) > 0 and int(lines["wrong"]) > 0
