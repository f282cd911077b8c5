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


@pytest.mark.parametrize("argv,exc,match", [
    # ported: they reach the command, which checks its input files
    pytest.param(["index", "-r", "a", "-v", "b", "-o", "c"], RuntimeError,
                 "File: a does not exist", id="argv0-index"),
    pytest.param(["vcf", "-z", "r.pkl", "-f", "p"], RuntimeError,
                 "File: r.pkl does not exist", id="argv1-vcf"),
    pytest.param(["sampling", "-i", "r", "-f", "p", "-o", "o", "-x", "3"],
                 NotImplementedError, "sampling", id="argv2-sampling"),
    pytest.param(["analyze-uk", "-i", "u.pkl"], NotImplementedError,
                 "analyze-uk", id="argv3-analyze-uk"),
    pytest.param(["genotype", "-i", "r.fa", "-f", "prefix"], RuntimeError,
                 "File: r.fa does not exist", id="argv4-genotype -f"),
    pytest.param(["genotype", "-i", "r.fa", "-r", "a.fa", "-v", "b.vcf", "-p"],
                 NotImplementedError, "phasing", id="argv5-phasing"),
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
