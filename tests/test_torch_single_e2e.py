"""The ``single`` command end to end: the port vs the reference package.

Both packages run ``run_single_command`` on the CPU in float64 on the
simulated workload of tests/test_simulation_e2e.py (60 kb, 8 samples =
17 paths, 25x reads). The genotyping VCF bodies (everything but the
``##`` header lines; ``##fileDate`` differs) must be identical, and
where haplotype sampling runs (``panel_size=6``) so must the sampled
paths and the sampled panel; with ``-p`` so must the phasing VCF bodies.
"""

import os

import numpy as np
import pytest
import torch

from pangenie_tpu.commands import run_single_command as jax_single
from pangenie_tpu.panel.sampling import reset_global_rand as jax_reset_rand
from pangenie_tpu_torch.commands import run_single_command as torch_single
from pangenie_tpu_torch.hmm import batch
from pangenie_tpu_torch.panel.sampling import reset_global_rand as torch_reset_rand
from pangenie_tpu_torch.utils import simulate as sim

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def fresh_rand_streams():
    """Path subsets (``sampling_size``) shuffle with each package's
    process-wide rand() replica, one stream per process as in the C++
    reference; other tests in the same process may have drawn from
    either. Both start from seed 1 in every test, so both packages draw
    the same subsets."""
    jax_reset_rand()
    torch_reset_rand()


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    d = tmp_path_factory.mktemp("single_e2e")
    rng = np.random.default_rng(1234)
    reference = sim.random_reference(60_000, rng)
    variants = sim.simulate_panel(reference, nr_samples=8, rng=rng)
    sim.write_inputs(str(d), reference, variants)
    hap1, hap2 = sim.haplotype_sequences(reference, variants, sample=0)
    sim.simulate_reads(hap1, hap2, coverage=25, read_length=100, rng=rng,
                       outfile=str(d / "reads.fa"))
    return d


def _body(path):
    with open(path) as f:
        return [line for line in f if not line.startswith("##")]


@pytest.mark.parametrize("options", [
    {"panel_size": 6, "output_panel": True},   # sampling engages
    {},                                        # all 17 paths
    {"sampling_size": 5},                      # path subsets, combined
], ids=["sampled_panel", "all_paths", "path_subsets"])
def test_single_command_matches_reference(workload, tmp_path, options):
    d = str(workload)
    inputs = (f"{d}/reads.fa", f"{d}/ref.fa", f"{d}/panel.vcf", 31)
    jax_out, torch_out = str(tmp_path / "jax"), str(tmp_path / "torch")
    assert jax_single(*inputs, jax_out, **options) == 0
    assert torch_single(*inputs, torch_out, device="cpu", **options) == 0
    assert batch.last_dispatch == "torch_ref"

    got, ref = _body(torch_out + "_genotyping.vcf"), _body(jax_out + "_genotyping.vcf")
    assert len(ref) > 50
    assert got == ref
    if options.get("output_panel"):
        with open(torch_out + "_paths_chr1.tsv") as a, open(jax_out + "_paths_chr1.tsv") as b:
            assert a.read() == b.read()
        assert _body(torch_out + "_panel.vcf") == _body(jax_out + "_panel.vcf")


@pytest.mark.parametrize("options", [
    {"only_genotyping": False},                          # single -g -p
    {"only_genotyping": False, "only_phasing": True},    # single -p
], ids=["genotype_and_phase", "phase_only"])
def test_phasing_matches_reference(workload, tmp_path, options):
    """``single`` with ``-p``: the phasing VCF body (and, with ``-g``, the
    genotyping one) equals the reference package's; ``-p`` alone writes
    no genotyping VCF."""
    d = str(workload)
    inputs = (f"{d}/reads.fa", f"{d}/ref.fa", f"{d}/panel.vcf", 31)
    jax_out, torch_out = str(tmp_path / "jax"), str(tmp_path / "torch")
    assert jax_single(*inputs, jax_out, **options) == 0
    assert torch_single(*inputs, torch_out, device="cpu", **options) == 0
    ref = _body(jax_out + "_phasing.vcf")
    assert len(ref) > 50
    assert _body(torch_out + "_phasing.vcf") == ref
    genotyped = not options.get("only_phasing")
    assert os.path.exists(torch_out + "_genotyping.vcf") == genotyped
    if genotyped:
        assert _body(torch_out + "_genotyping.vcf") == _body(jax_out + "_genotyping.vcf")
