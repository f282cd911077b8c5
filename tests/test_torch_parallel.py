"""The port's sharded genotyping steps (``pangenie_tpu_torch/parallel/``)
against the JAX package's, on gloo process groups of spawned CPU
processes (``test_torch_distributed.run_ranks``) and on the conftest's
8 virtual CPU devices. The spawned ranks import this module, so it
imports JAX only inside the tests.

``sharded_forward_backward`` on 4 ranks as a 2 x 2 (subset, batch) mesh
must give the JAX version's posteriors on a 4-device mesh from the same
``synthetic_columns`` in float64 to rtol 1e-12 (the port's plain
forward-backward against the reference's XLA scan: the two transition
forms agree that far); ``sharded_viterbi`` the same states;
``run_grid_local_sharded`` over ``[cpu, cpu]`` the one-device results
bit for bit; and ``dryrun_multigpu`` runs on 4 ranks.
"""

import numpy as np
import pytest
import torch

from pangenie_tpu_torch.hmm.batch import forward_backward_batch
from pangenie_tpu_torch.hmm.forward_backward import ColumnArrays, columns_from_numpy
from pangenie_tpu_torch.hmm.viterbi import viterbi
from pangenie_tpu_torch.parallel import mesh as torch_mesh
from pangenie_tpu_torch.parallel.genotyping import run_grid_local_sharded
from pangenie_tpu_torch.utils.synthetic import synthetic_columns
from test_torch_distributed import run_ranks

CPU = torch.device("cpu")
S, B, N, P, K = 2, 4, 16, 4, 4


def _jax():
    """The JAX package's parallel modules and synthetic columns (imported
    here, not in the spawned ranks)."""
    import jax

    from pangenie_tpu.parallel import genotyping, mesh
    from pangenie_tpu.utils.synthetic import synthetic_columns as columns

    if jax.device_count() < 4:
        pytest.skip("needs 4 (virtual) devices")
    return genotyping, mesh, columns


def _jax_grid(shape, seed, n_alleles=2):
    """The JAX mesh and [S, B] columns placed on it."""
    import jax.numpy as jnp

    par, mesh_mod, columns = _jax()
    cols = columns(n_columns=N, n_paths=P, n_kmers=K, n_alleles=n_alleles,
                   batch_dims=(S if shape[0] > 1 else 1, B), seed=seed)
    mesh = mesh_mod.make_mesh(4, shape=shape)
    return par, mesh, par.shard_columns(mesh, type(cols)(*[jnp.asarray(x) for x in cols]))


def test_factor_2d_is_the_references():
    from pangenie_tpu.parallel import mesh as jax_mesh

    for n in range(1, 13):
        assert torch_mesh._factor_2d(n) == jax_mesh._factor_2d(n), n


def _columns(batch_dims, seed, n_alleles=2):
    return columns_from_numpy(
        synthetic_columns(n_columns=N, n_paths=P, n_kmers=K, n_alleles=n_alleles,
                          batch_dims=batch_dims, seed=seed),
        CPU, torch.float64)


def grid_rank(shape, seed, n_alleles):
    """sharded_forward_backward and sharded_viterbi at this rank: its
    mesh coordinates and block results."""
    from pangenie_tpu_torch.parallel.genotyping import (
        shard_columns, sharded_forward_backward, sharded_viterbi)
    from pangenie_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(shape)
    local = shard_columns(mesh, _columns((S if shape[0] > 1 else 1, B), seed, n_alleles))
    out = dict(coords=(mesh.get_local_rank(0), mesh.get_local_rank(1)))
    posts, corr = sharded_forward_backward(mesh, local)
    out.update(posts=posts.numpy(), corr=corr.numpy())
    if shape[0] == 1:
        out["states"] = sharded_viterbi(mesh, local).numpy()
    return out


def _assemble(results, key):
    """The [B, ...] result from the ranks of subset row 0, in batch order."""
    blocks = sorted((r["coords"][1], r[key]) for r in results if r["coords"][0] == 0)
    return np.concatenate([b for _, b in blocks])


@pytest.mark.parametrize("n_alleles", [2, 4])
def test_sharded_forward_backward_matches_jax(tmp_path, n_alleles):
    """A 2 x 2 mesh: each rank one subset of two batch items, the
    subsets summed by the all-reduce over ``subset``."""
    par, mesh, device_cols = _jax_grid((2, 2), 3, n_alleles)
    want_posts, want_corr = par.sharded_forward_backward(mesh, device_cols)
    results = run_ranks(tmp_path, 4, "test_torch_parallel:grid_rank", ((2, 2), 3, n_alleles))
    # both subset rows hold the same sums
    for r in results:
        twin = next(q for q in results if q["coords"] == (1 - r["coords"][0], r["coords"][1]))
        np.testing.assert_array_equal(r["posts"], twin["posts"])
    np.testing.assert_allclose(_assemble(results, "posts"), np.asarray(want_posts), rtol=1e-12)
    np.testing.assert_allclose(_assemble(results, "corr"), np.asarray(want_corr), rtol=1e-12)


def test_sharded_viterbi_matches_jax(tmp_path):
    """A 1 x 4 mesh (phasing runs one subset): each rank one chain."""
    par, mesh, device_cols = _jax_grid((1, 4), 5)
    want = np.asarray(par.sharded_viterbi(mesh, device_cols))
    results = run_ranks(tmp_path, 4, "test_torch_parallel:grid_rank", ((1, 4), 5, 2))
    got = _assemble(results, "states")
    # the one-process port on the same chains
    assert np.array_equal(got, viterbi(ColumnArrays(*[x[0] for x in _columns((1, B), 5)])).numpy())
    assert np.array_equal(got, want)


@pytest.mark.parametrize("run_g, run_p", [(True, False), (False, True)],
                         ids=["forward_backward", "viterbi"])
def test_grid_over_local_devices_is_bit_identical(run_g, run_p):
    """3 work items over [cpu, cpu]: padded to 4 with a copy of the first,
    two a device; the results equal the one-device batch's bit for bit."""
    cols = _columns((3,), 7, 4)
    members = [ColumnArrays(*[x[i] for x in cols]) for i in range(3)]
    posts, corr, states = run_grid_local_sharded(members, run_g, run_p, False, [CPU, CPU])
    if run_g:
        want_posts, want_corr = forward_backward_batch(cols)
        assert posts.shape == tuple(want_posts.shape) and states is None
        assert np.array_equal(posts, want_posts.numpy())
        assert np.array_equal(corr, want_corr.numpy())
    else:
        assert posts is None and corr is None
        assert np.array_equal(states, viterbi(cols).numpy())


def test_genotype_spreads_over_local_devices(tmp_path, monkeypatch):
    """``genotype -f -a -g -p``: every batch that is not a long run goes
    through run_grid_local_sharded, over the one device and then over
    two devices visible to one process; the VCF bodies are the same."""
    from pangenie_tpu_torch import cli
    from pangenie_tpu_torch.hmm import genotyping
    from pangenie_tpu_torch.panel.sampling import reset_global_rand
    from pangenie_tpu_torch.parallel import genotyping as par
    from test_torch_distributed import _body, _build_inputs

    _build_inputs(tmp_path, np.random.default_rng(23))
    calls = {}

    def spread(members, run_g, run_p, uniform, devices):
        calls.setdefault(len(devices), []).append(len(members))
        return run_grid(members, run_g, run_p, uniform, devices)

    run_grid = par.run_grid_local_sharded
    monkeypatch.setattr(par, "run_grid_local_sharded", spread)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("PANGENIE_TORCH_DEVICE", "cpu")
    assert cli.main(["index", "-r", "ref.fa", "-v", "panel.vcf", "-o", "idx"]) == 0
    argv = ["genotype", "-i", "reads.fa", "-f", "idx", "-a", "5", "-g", "-p"]
    reset_global_rand()
    assert cli.main([*argv, "-o", "one"]) == 0
    monkeypatch.setattr(genotyping, "_local_cards", lambda device: [CPU, CPU])
    reset_global_rand()
    assert cli.main([*argv, "-o", "two"]) == 0
    assert set(calls) == {1, 2} and calls[1] == calls[2]
    assert any(n > 1 for n in calls[2])
    for kind in ("genotyping", "phasing"):
        assert _body(tmp_path / f"two_{kind}.vcf") == _body(tmp_path / f"one_{kind}.vcf")


def dryrun_rank(world):
    from pangenie_tpu_torch.parallel.dryrun import dryrun_multigpu

    return dryrun_multigpu(world)


def test_dryrun_multigpu_on_four_ranks(tmp_path):
    results = run_ranks(tmp_path, 4, "test_torch_parallel:dryrun_rank", (4,))
    assert [r["rank"] for r in results] == [0, 1, 2, 3]
    assert all(r["grid"] == (2, 2) and r["device"] == "cpu" for r in results)
    # the partitions hold every key once, about a quarter each
    n_keys = sum(r["partition_keys"] for r in results)
    assert all(0.2 * n_keys < r["partition_keys"] < 0.3 * n_keys for r in results)
