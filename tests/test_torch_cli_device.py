"""The port's device rule and CLI surface (no card needed), and the
``sampling`` and ``analyze-uk`` commands against the reference
package's on a small simulated panel."""

import numpy as np
import pytest
import torch

from pangenie_tpu import commands as jax_commands
from pangenie_tpu_torch import cli
from pangenie_tpu_torch.device import hmm_dtype, resolve_device
from pangenie_tpu_torch.utils import simulate as sim

torch.set_num_threads(1)


def test_device_from_argument_and_environment(monkeypatch):
    monkeypatch.delenv("PANGENIE_TORCH_DEVICE", raising=False)
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setenv("PANGENIE_TORCH_DEVICE", "cpu")
    assert resolve_device() == torch.device("cpu")


def test_cuda_requested_without_a_card_raises(monkeypatch):
    monkeypatch.delenv("PANGENIE_TORCH_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        resolve_device()              # the default is cuda
    with pytest.raises(RuntimeError, match="is_available"):
        resolve_device("cuda:0")


def test_hmm_dtype_rule():
    assert hmm_dtype(torch.device("cpu")) == torch.float64
    assert hmm_dtype(torch.device("cuda")) == torch.float32


@pytest.mark.parametrize("argv,exc,match", [
    # ported: they reach the command, which checks its input files
    pytest.param(["index", "-r", "a", "-v", "b", "-o", "c"], RuntimeError,
                 "File: a does not exist", id="argv0-index"),
    pytest.param(["vcf", "-z", "r.pkl", "-f", "p"], RuntimeError,
                 "File: r.pkl does not exist", id="argv1-vcf"),
    pytest.param(["sampling", "-i", "r", "-f", "p", "-o", "o", "-x", "3"],
                 RuntimeError, "File: r does not exist", id="argv2-sampling"),
    pytest.param(["analyze-uk", "-i", "u.pkl"], RuntimeError,
                 "File: u.pkl does not exist", id="argv3-analyze-uk"),
    pytest.param(["genotype", "-i", "r.fa", "-f", "prefix"], RuntimeError,
                 "File: r.fa does not exist", id="argv4-genotype -f"),
    pytest.param(["genotype", "-i", "r.fa", "-r", "a.fa", "-v", "b.vcf", "-p"],
                 RuntimeError, "File: a.fa does not exist", id="argv5-phasing"),
])
def test_commands_not_ported_yet_name_their_roadmap_item(tmp_path, monkeypatch,
                                                         argv, exc, match):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("PANGENIE_TORCH_DEVICE", "cpu")
    with pytest.raises(exc, match=match) as info:
        cli.main(argv)
    if exc is NotImplementedError:
        assert "ROADMAP" in str(info.value)


def test_genotype_requires_reference_and_variants():
    with pytest.raises(SystemExit):
        cli.main(["genotype", "-i", "r.fa", "-r", "a.fa"])


@pytest.fixture(scope="module")
def two_chromosomes(tmp_path_factory):
    """Two simulated chromosomes of 30 kb, 8 samples (17 paths with the
    reference), 20x reads of sample 0; indexed by both packages."""
    d = tmp_path_factory.mktemp("sampling_command")
    rng = np.random.default_rng(77)
    with open(d / "ref.fa", "w") as fa, open(d / "panel.vcf", "w") as vcf, \
            open(d / "reads.fa", "wb") as reads:
        vcf.write("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER"
                  "\tINFO\tFORMAT\t" + "\t".join(f"S{i}" for i in range(8)) + "\n")
        for name in ("chr1", "chr2"):
            ref = sim.random_reference(30_000, rng)
            variants = sim.simulate_panel(ref, nr_samples=8, rng=rng)
            fa.write(f">{name}\n{ref.decode()}\n")
            vcf.write("".join(
                f"{name}\t{v.position + 1}\t.\t{v.ref.decode()}\t"
                f"{','.join(a.decode() for a in v.alts)}\t.\tPASS\t.\tGT\t"
                + "\t".join(f"{a}|{b}" for a, b in v.genotypes) + "\n" for v in variants))
            sim.simulate_reads_to_file(*sim.haplotype_sequences(ref, variants, 0), 20.0,
                                       100, rng, reads)
    inputs = (str(d / "ref.fa"), str(d / "panel.vcf"), 31)
    assert jax_commands.run_index_command(*inputs, str(d / "jax")) == 0
    assert cli.main(["index", "-r", inputs[0], "-v", inputs[1], "-o", str(d / "torch")]) == 0
    return d


def _read(path):
    with open(path) as f:
        return f.read()


def test_sampling_command_matches_reference(two_chromosomes, tmp_path, monkeypatch):
    """``sampling -x 3`` after ``index``: the panel VCF of the 3 sampled
    haplotypes and the reference path, and every chromosome's paths TSV,
    are the reference package's, byte for byte."""
    d = two_chromosomes
    monkeypatch.setenv("PANGENIE_TORCH_DEVICE", "cpu")
    reads = str(d / "reads.fa")
    jax_out, torch_out = str(tmp_path / "jax"), str(tmp_path / "torch")
    assert jax_commands.run_sampling(str(d / "jax"), reads, jax_out, panel_size=3) == 0
    assert cli.main(["sampling", "-i", reads, "-f", str(d / "torch"), "-o", torch_out,
                     "-x", "3"]) == 0
    panel = _read(torch_out + "_panel.vcf")
    assert panel == _read(jax_out + "_panel.vcf")
    header = [line for line in panel.splitlines() if line.startswith("#CHROM")]
    assert len(header) == 1 and len(header[0].split("\t")) == 9 + 4  # one per haplotype
    body = [line for line in panel.splitlines() if not line.startswith("#")]
    assert {line.split("\t")[0] for line in body} == {"chr1", "chr2"}
    for chrom in ("chr1", "chr2"):
        tsv = _read(f"{torch_out}_paths_{chrom}.tsv")
        assert tsv == _read(f"{jax_out}_paths_{chrom}.tsv")
        assert tsv.splitlines()[0].count("HaplotypeID_path") == 4


def test_analyze_uk_prints_the_reference_stdout(two_chromosomes, capsys):
    d = two_chromosomes
    assert jax_commands.run_analyze_uk(str(d / "jax_UniqueKmersMap.pkl")) == 0
    want = capsys.readouterr().out
    assert cli.main(["analyze-uk", "-i", str(d / "torch_UniqueKmersMap.pkl")]) == 0
    got = capsys.readouterr().out
    assert got == want and len(want.splitlines()) > 100
