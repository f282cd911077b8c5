"""``index`` + ``genotype -f`` (and ``-w`` + ``vcf``): the port vs the
reference package, on a panel with many-allele SV sites.

The workload is that of tests/test_torch_single_e2e.py (60 kb, 8
samples = 17 paths, 25x reads) with SV insertions planted and every SV
site rewritten into one record with 9-12 distinct insertion ALTs
(:func:`rewrite_sv_sites`), so the HMM's allele count exceeds 8
and the port takes the generic route (``torch_generic``: the plain
versions of kernels K3/K4). Both packages index the panel and genotype
from the index on the CPU in float64; the genotyping VCF bodies
(everything but the ``##`` header lines) must be identical. With
the segment length lowered in both packages (``PairHMM.SEGMENT`` in the
reference, ``fb_generic.SEGMENT`` in the port) the reference streams
the chromosome in segments and the port walks it in several chunks.
With ``-p`` (``only_genotyping=False``) the phasing VCF bodies must be
identical too, also from ``-w`` + ``vcf -p``, and on the long
chromosome, which both packages phase through the checkpointed Viterbi.
"""

import os

import numpy as np
import pytest
import torch

from pangenie_tpu.commands import run_genotype_command as jax_genotype
from pangenie_tpu.commands import run_index_command as jax_index
from pangenie_tpu.commands import run_vcf_command as jax_vcf
from pangenie_tpu.hmm.genotyping import PairHMM as JaxPairHMM
from pangenie_tpu.panel.sampling import reset_global_rand as jax_reset_rand
from pangenie_tpu_torch import commands
from pangenie_tpu_torch.hmm import batch, fb_generic
from pangenie_tpu_torch.panel.sampling import reset_global_rand as torch_reset_rand
from pangenie_tpu_torch.utils import simulate as sim

torch.set_num_threads(1)


def rewrite_sv_sites(variants, rng, n_alts, lengths=(100, 400)):
    """Every SV site of ``simulate_panel(sv_fraction=...)`` (an insertion
    of 100 bp or more) becomes one record with ``n_alts[0]``..``n_alts[1]``
    distinct insertion ALTs of ``lengths`` bp, each carried by at least
    one haplotype (so the HMM column has more than 8 alleles). Returns
    the number of sites rewritten."""
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    rewritten = 0
    for v in variants:
        if len(v.alts[0]) - len(v.ref) < 100:
            continue
        n = int(rng.integers(n_alts[0], n_alts[1] + 1))
        alts = set()
        while len(alts) < n:
            size = int(rng.integers(lengths[0], lengths[1] + 1))
            alts.add(v.ref + bases[rng.integers(0, 4, size)].tobytes())
        v.alts = sorted(alts)
        haps = rng.integers(0, n + 1, 2 * len(v.genotypes))
        haps[rng.permutation(len(haps))[:n]] = np.arange(1, n + 1)
        v.genotypes = [(int(a), int(b)) for a, b in haps.reshape(-1, 2)]
        rewritten += 1
    return rewritten


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
    d = tmp_path_factory.mktemp("index_genotype")
    rng = np.random.default_rng(1234)
    reference = sim.random_reference(60_000, rng)
    variants = sim.simulate_panel(reference, nr_samples=8, rng=rng,
                                  sv_fraction=0.06)
    assert rewrite_sv_sites(variants, rng, (9, 12)) >= 3
    sim.write_inputs(str(d), reference, variants)
    hap1, hap2 = sim.haplotype_sequences(reference, variants, sample=0)
    sim.simulate_reads(hap1, hap2, coverage=25, read_length=100, rng=rng,
                       outfile=str(d / "reads.fa"))
    inputs = (str(d / "ref.fa"), str(d / "panel.vcf"), 31)
    assert jax_index(*inputs, str(d / "jax_index")) == 0
    assert commands.run_index_command(*inputs, str(d / "torch_index")) == 0
    return d


def _body(path):
    with open(path) as f:
        return [line for line in f if not line.startswith("##")]


def _genotype_both(d, tmp_path, **options):
    reads = str(d / "reads.fa")
    jax_out, torch_out = str(tmp_path / "jax"), str(tmp_path / "torch")
    assert jax_genotype(str(d / "jax_index"), reads, jax_out, **options) == 0
    fb_generic.last_walk = (0, 0, 0)
    assert commands.run_genotype_command(
        str(d / "torch_index"), reads, torch_out, device="cpu", **options) == 0
    for kind, made in (("genotyping", not options.get("only_phasing")),
                       ("phasing", options.get("only_genotyping") is False)):
        assert os.path.exists(torch_out + f"_{kind}.vcf") == made
        if made:
            ref = _body(jax_out + f"_{kind}.vcf")
            assert len(ref) > 50
            assert _body(torch_out + f"_{kind}.vcf") == ref
    return torch_out


@pytest.mark.parametrize("options", [
    {},                                        # all 17 paths
    {"sampling_size": 5},                      # path subsets, combined
    {"panel_size": 6, "output_panel": True},   # haplotype sampling engages
], ids=["all_paths", "path_subsets", "sampled_panel"])
def test_genotype_from_index_matches_reference(workload, tmp_path, options):
    out = _genotype_both(workload, tmp_path, **options)
    if not options.get("panel_size"):
        assert batch.last_dispatch == "torch_generic"
        assert fb_generic.last_walk[2] == 1
    if options.get("output_panel"):
        jax_out = str(tmp_path / "jax")
        with open(out + "_paths_chr1.tsv") as a, open(jax_out + "_paths_chr1.tsv") as b:
            assert a.read() == b.read()
        assert _body(out + "_panel.vcf") == _body(jax_out + "_panel.vcf")


def test_long_chromosome_is_chunked(workload, tmp_path, monkeypatch):
    monkeypatch.setattr(JaxPairHMM, "SEGMENT", 64)
    monkeypatch.setattr(fb_generic, "SEGMENT", 64)
    _genotype_both(workload, tmp_path)
    assert batch.last_dispatch == "torch_generic"
    assert fb_generic.last_walk[2] > 1


def test_serialized_results_then_vcf(workload, tmp_path):
    d = workload
    out = str(tmp_path / "w")
    assert commands.run_genotype_command(
        str(d / "torch_index"), str(d / "reads.fa"), out, device="cpu",
        serialize_output=True) == 0
    assert not os.path.exists(out + "_genotyping.vcf")
    assert commands.run_vcf_command(str(d / "torch_index"), out + "_genotyping.pkl",
                                    out) == 0
    direct = _genotype_both(d, tmp_path)
    assert _body(out + "_genotyping.vcf") == _body(direct + "_genotyping.vcf")


def test_single_agrees_with_index_then_genotype(workload, tmp_path):
    d = workload
    out = str(tmp_path / "single")
    assert commands.run_single_command(
        str(d / "reads.fa"), str(d / "ref.fa"), str(d / "panel.vcf"), 31, out,
        device="cpu") == 0
    staged = str(tmp_path / "staged")
    assert commands.run_genotype_command(
        str(d / "torch_index"), str(d / "reads.fa"), staged, device="cpu") == 0
    assert _body(out + "_genotyping.vcf") == _body(staged + "_genotyping.vcf")



@pytest.mark.parametrize("options", [
    {"only_genotyping": False},                          # genotype -f -g -p
    {"only_genotyping": False, "only_phasing": True},    # genotype -f -p
    {"only_genotyping": False, "sampling_size": 5},      # -g -p over subsets
], ids=["genotype_and_phase", "phase_only", "path_subsets"])
def test_phasing_from_index_matches_reference(workload, tmp_path, options):
    _genotype_both(workload, tmp_path, **options)


def test_long_chromosome_phasing_is_checkpointed(workload, tmp_path, monkeypatch):
    """Over the segment length both packages phase through the
    checkpointed Viterbi, the columns padded to a bucket."""
    monkeypatch.setattr(JaxPairHMM, "SEGMENT", 64)
    monkeypatch.setattr(fb_generic, "SEGMENT", 64)
    _genotype_both(workload, tmp_path, only_genotyping=False)
    assert fb_generic.last_walk[2] > 1


def test_serialized_results_then_vcf_phasing(workload, tmp_path):
    """``genotype -f -g -p -w`` then ``vcf -p`` and ``vcf -g -p``, in both
    packages: the phasing (and genotyping) VCF bodies are identical."""
    d = workload
    reads = str(d / "reads.fa")
    jax_out, torch_out = str(tmp_path / "jax"), str(tmp_path / "torch")
    assert jax_genotype(str(d / "jax_index"), reads, jax_out, only_genotyping=False,
                        serialize_output=True) == 0
    assert commands.run_genotype_command(
        str(d / "torch_index"), reads, torch_out, device="cpu", only_genotyping=False,
        serialize_output=True) == 0
    for flags, kinds in (((False, True), ("phasing",)),
                         ((False, False), ("genotyping", "phasing"))):
        jax_vcf(str(d / "jax_index"), jax_out + "_genotyping.pkl", jax_out + "_v", "sample",
                *flags)
        commands.run_vcf_command(str(d / "torch_index"), torch_out + "_genotyping.pkl",
                                 torch_out + "_v", "sample", *flags)
        for kind in kinds:
            ref = _body(jax_out + f"_v_{kind}.vcf")
            assert len(ref) > 50
            assert _body(torch_out + f"_v_{kind}.vcf") == ref
