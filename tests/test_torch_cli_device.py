"""The port's device rule and CLI surface (no card needed)."""

import pytest
import torch

from pangenie_tpu_torch import cli
from pangenie_tpu_torch.device import hmm_dtype, resolve_device

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


@pytest.mark.parametrize("argv,match", [
    (["index", "-r", "a", "-v", "b", "-o", "c"], "index"),
    (["vcf", "-z", "r.pkl", "-f", "p"], "vcf"),
    (["sampling", "-i", "r", "-f", "p", "-o", "o", "-x", "3"], "sampling"),
    (["analyze-uk", "-i", "u.pkl"], "analyze-uk"),
    (["genotype", "-i", "r.fa", "-f", "prefix"], "genotype -f"),
    (["genotype", "-i", "r.fa", "-r", "a.fa", "-v", "b.vcf", "-p"], "phasing"),
])
def test_commands_not_ported_yet_name_their_roadmap_item(argv, match):
    with pytest.raises(NotImplementedError, match=match) as info:
        cli.main(argv)
    assert "ROADMAP" in str(info.value)


def test_genotype_requires_reference_and_variants():
    with pytest.raises(SystemExit):
        cli.main(["genotype", "-i", "r.fa", "-r", "a.fa"])
