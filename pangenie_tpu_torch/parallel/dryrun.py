"""The sharded steps run once from each rank of a process group.

Counterpart of the reference's ``__graft_entry__.dryrun_multichip``: the
(path-subset x chromosome-block) genotyping grid on a mesh of the ranks
(an all-reduce over ``subset``), read k-mer counting with the graph
table hash-partitioned over the ranks (an all-to-all a step), and the
haplotype-sampling min-plus scan (kernel S1 on a card) on each rank's
share of a batch of chromosomes. Every rank calls :func:`dryrun_multigpu`
after ``distributed.maybe_initialize``; it raises where a result is
wrong and returns what each step gave.
"""

from __future__ import annotations

import numpy as np
import torch

from . import distributed


def dryrun_multigpu(world: int, device=None) -> dict:
    from ..device import hmm_dtype, resolve_device
    from ..hmm.forward_backward import columns_from_numpy
    from ..hmm.sampling import UINT_MAX, viterbi_iteration
    from ..kmers.counter import ExactKmerCounter
    from ..kmers.device_counter import ShardedPrimedDeviceCounter
    from ..utils.synthetic import synthetic_columns
    from .genotyping import shard_columns, sharded_forward_backward
    from .mesh import make_mesh

    if distributed.process_count() != world:
        raise RuntimeError(f"dryrun_multigpu({world}) in a world of "
                           f"{distributed.process_count()} ranks")
    dev = resolve_device(device)
    rank = distributed.process_index()
    out = {"rank": rank, "device": str(dev)}

    # the grid at a production bucket: P=32 paths after sampling, N=1024
    # columns, K=16 k-mers; one work item a rank
    mesh = make_mesh()
    s_mesh, b_mesh = mesh.size(0), mesh.size(1)
    columns = columns_from_numpy(
        synthetic_columns(n_columns=1024, n_paths=32, n_kmers=16, batch_dims=(s_mesh, b_mesh)),
        torch.device("cpu"), hmm_dtype(dev))
    posteriors, log_corr = sharded_forward_backward(mesh, shard_columns(mesh, columns, dev))
    result = posteriors.cpu().numpy()
    if result.shape[0] != 1 or log_corr.shape != (1, 1024):
        raise AssertionError(f"grid block of shape {result.shape}, {tuple(log_corr.shape)}")
    if not np.all(np.isfinite(result)) or not np.all(result >= 0.0):
        raise AssertionError("non-finite or negative posteriors")
    out["grid"] = (s_mesh, b_mesh)

    # the partitioned counter on genome-slice reads: every window is a
    # graph k-mer, so every window is counted; two ingest steps
    rng = np.random.default_rng(0)
    k = 31
    genome = rng.integers(0, 4, size=100_000).astype(np.uint8)
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    keys = np.unique(ExactKmerCounter._extract_canonical([lut[genome].tobytes()], k))
    counter = ShardedPrimedDeviceCounter(k, keys, device=dev)
    starts = rng.integers(0, len(genome) - 150, size=2 * world * 64)
    reads = genome[starts[:, None] + np.arange(150)[None, :]]
    half = len(reads) // 2
    counter.update_batch(reads[:half][rank::world])
    counter.update_batch(reads[half:][rank::world])
    _, counts = counter.to_host_arrays()
    windows = len(reads) * (150 - k + 1)
    if counts.sum() != windows:
        raise AssertionError(f"{counts.sum()} windows counted of {windows}")
    out["partition_keys"] = len(counter.table.keys)

    # sampling at a post-merge production shape: a 123-path panel block,
    # one chromosome a rank
    B, N, P = world, 2048, 123
    cost = rng.integers(0, 50, size=(B, N, P)).astype(np.int32)
    switch = rng.integers(1, 40, size=(B, N)).astype(np.int32)
    share = slice(rank, rank + 1)
    paths, best = viterbi_iteration(
        torch.from_numpy(cost[share]).to(dev), torch.ones((1, N, P), dtype=torch.bool, device=dev),
        torch.from_numpy(switch[share]).to(dev))
    if tuple(paths.shape) != (1, N) or not bool((best < UINT_MAX).all()):
        raise AssertionError("sampling scan gave a wrong shape or no path")
    out["sampling_best"] = int(best[0])
    distributed.barrier()
    return out
