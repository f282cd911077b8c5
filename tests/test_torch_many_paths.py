"""More than 128 paths: the route past the fused kernels, the port vs
the reference package.

A panel of 70 samples (140 haplotypes + the reference = 141 paths) over
a 100 kb chromosome (about 250 variants), 20x reads of sample 0. Both
packages index it and run ``genotype -f -a 130`` on the CPU in float64:
two path subsets of 130 paths, each past K1/K2's 128, so the port's batch
takes the generic route (``torch_generic``: the plain versions of K3/K4,
whose cluster tier takes such P on the card) while the reference, past its
96-path Pallas limit, runs its XLA scan. The genotyping VCF bodies
must be identical.
"""

import numpy as np
import pytest
import torch

from pangenie_tpu.commands import run_genotype_command as jax_genotype
from pangenie_tpu.commands import run_index_command as jax_index
from pangenie_tpu.panel.sampling import reset_global_rand as jax_reset_rand
from pangenie_tpu_torch import commands
from pangenie_tpu_torch.hmm import batch, fb_generic, fb_kernels
from pangenie_tpu_torch.panel.sampling import reset_global_rand as torch_reset_rand
from pangenie_tpu_torch.utils import simulate as sim
from pangenie_tpu_torch.hmm.forward_backward import columns_from_numpy
from pangenie_tpu_torch.utils.synthetic import synthetic_columns

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    d = tmp_path_factory.mktemp("many_paths")
    rng = np.random.default_rng(77)
    reference = sim.random_reference(100_000, rng)
    variants = sim.simulate_panel(reference, nr_samples=70, rng=rng)
    sim.write_inputs(str(d), reference, variants)
    hap1, hap2 = sim.haplotype_sequences(reference, variants, sample=0)
    sim.simulate_reads(hap1, hap2, coverage=20, read_length=100, rng=rng,
                       outfile=str(d / "reads.fa"))
    inputs = (str(d / "ref.fa"), str(d / "panel.vcf"), 31)
    assert jax_index(*inputs, str(d / "jax_index")) == 0
    assert commands.run_index_command(*inputs, str(d / "torch_index")) == 0
    return d


def _body(path):
    with open(path) as f:
        return [line for line in f if not line.startswith("##")]


def test_path_subsets_past_128_match_reference(workload, tmp_path):
    d = workload
    reads = str(d / "reads.fa")
    jax_out, torch_out = str(tmp_path / "jax"), str(tmp_path / "torch")
    # each package draws its subsets from a process-wide rand() stream
    jax_reset_rand()
    torch_reset_rand()
    assert jax_genotype(str(d / "jax_index"), reads, jax_out, sampling_size=130) == 0
    assert commands.run_genotype_command(str(d / "torch_index"), reads, torch_out,
                                         device="cpu", sampling_size=130) == 0
    assert batch.last_dispatch == "torch_generic"
    # the chromosome's two subsets of 130 paths, as [B, N, P] columns
    B, N, _chunks = fb_generic.last_walk
    assert B == 2 and N > 50
    ref = _body(jax_out + "_genotyping.vcf")
    assert len(ref) > 50
    assert _body(torch_out + "_genotyping.vcf") == ref
    with open(str(d / "panel.vcf")) as f:
        header = next(line for line in f if line.startswith("#CHROM"))
    assert len(header.split("\t")) - 9 == 70


@pytest.mark.parametrize("P,generic", [(128, False), (129, True)])
def test_route_by_path_count(P, generic):
    """A short chain of A <= 8 alleles takes the fused route up to
    fb_kernels.MAX_PATHS paths and the generic route past it, whatever
    the device."""
    assert fb_kernels.MAX_PATHS == 128
    cols = columns_from_numpy(
        synthetic_columns(n_columns=4, n_paths=P, n_alleles=2, batch_dims=(1,)),
        "cpu", torch.float64)
    assert batch.use_generic(cols) is generic
