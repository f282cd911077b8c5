"""Sharded genotyping step over the ranks, and the grid over one
process's cards.

Port of ``pangenie_tpu/parallel/genotyping.py``. The genotyping
workload is a grid of independent HMM runs over (path-subset s,
work-item b); per variant the raw allele-pair likelihoods of all subsets
are summed before the final normalization (reference
src/commands.cpp:155-185, 980-988). Under a (subset, batch) mesh of ranks
(``parallel/mesh.py``) each rank holds a [S_loc, B_loc] block of the
grid, runs it through ``forward_backward_batch`` (kernels K1/K2, or
K3/K4, on its card), sums its local subsets and all-reduces the sum over
the mesh's ``subset`` group: the reference's ``psum``.

:func:`run_grid_local_sharded` is the other layout: one process, several
cards, the work items split over them with no collective at all.
"""

from __future__ import annotations

import contextlib
from typing import List, Sequence

import numpy as np
import torch

from ..hmm.batch import forward_backward_batch
from ..hmm.forward_backward import ColumnArrays
from ..hmm.viterbi import viterbi
from . import distributed


def _flatten(columns: ColumnArrays) -> ColumnArrays:
    s_loc, b_loc = columns.alleles.shape[:2]
    return ColumnArrays(*[x.reshape((s_loc * b_loc,) + tuple(x.shape[2:])) for x in columns])


def shard_columns(mesh, columns: ColumnArrays, device=None) -> ColumnArrays:
    """This rank's [S_loc, B_loc, ...] block of [S, B, ...] columns, on
    ``device`` (default: the columns' own): rows of its ``subset``
    coordinate, columns of its ``batch`` coordinate. S and B must be
    divisible by the mesh's dims."""
    s_mesh, b_mesh = mesh.size(0), mesh.size(1)
    s_i, b_i = mesh.get_local_rank(0), mesh.get_local_rank(1)
    S, B = columns.alleles.shape[:2]
    if S % s_mesh or B % b_mesh:
        raise ValueError(f"shard_columns: grid [{S}, {B}] does not divide over the mesh "
                         f"[{s_mesh}, {b_mesh}]")
    s_loc, b_loc = S // s_mesh, B // b_mesh
    return ColumnArrays(*[
        x[s_i * s_loc:(s_i + 1) * s_loc, b_i * b_loc:(b_i + 1) * b_loc]
        .to(device or x.device).contiguous() for x in columns])


def sharded_forward_backward(mesh, columns: ColumnArrays):
    """Run this rank's [S_loc, B_loc] block of the grid (:func:`shard_columns`).

    Returns:
      posteriors [B_loc, N, A, A]: the block's allele-pair likelihood
        grids (emission-rescaled), summed over every path subset of the
        mesh,
      log_correction [B_loc, N]: per-column log factors restoring the
        reference's raw likelihood scale (see forward_backward).
    """
    s_loc, b_loc = columns.alleles.shape[:2]
    posts, corr = forward_backward_batch(_flatten(columns))
    posts = posts.reshape((s_loc, b_loc) + tuple(posts.shape[1:]))
    corr = corr.reshape((s_loc, b_loc) + tuple(corr.shape[1:]))
    # the log-correction is subset-independent (scale depends only on
    # the column's kmer probabilities), so summing SCALED raw posteriors
    # across subsets is exact; host code applies exp(corr) once
    local = posts.sum(dim=0)
    distributed.all_reduce_sum_(local, mesh.get_group("subset"))
    return local, corr[0]


def sharded_viterbi(mesh, columns: ColumnArrays, uniform: bool = False) -> torch.Tensor:
    """Viterbi states [B_loc, N] of this rank's batch block: phasing
    runs use one path subset, so the block's first subset (kernel V1 on
    a card)."""
    return viterbi(ColumnArrays(*[x[0] for x in columns]), uniform)


def _on(device: torch.device):
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def run_grid_local_sharded(members_cols: Sequence[ColumnArrays], run_g: bool, run_p: bool,
                           uniform: bool, devices: List[torch.device]):
    """Execute a stacked [B, ...] HMM grid across ``devices`` (a
    process's cards; repeats allowed).

    The counterpart of the reference's thread pool over the (chromosome x
    subset) grid (src/commands.cpp:955-978): the B work items, padded to
    a multiple of the devices used with copies of the first (as the
    reference pads), split into equal contiguous blocks, one a device;
    each block runs through the same forward_backward_batch and viterbi
    entry points, launched on every device before any result is read.
    No math crosses work items, so the results equal the one-device
    call's bit for bit.

    Returns (posteriors [B, N, A, A] | None, log_corr [B, N] | None,
             states [B, N] | None) as numpy arrays trimmed to B.
    """
    B = len(members_cols)
    n_use = min(len(devices), B)
    per = (B + n_use - 1) // n_use
    stacked = ColumnArrays(*[torch.stack(xs) for xs in zip(*members_cols)])
    if per * n_use != B:
        stacked = ColumnArrays(*[
            torch.cat([x, x[:1].expand((per * n_use - B,) + tuple(x.shape[1:]))])
            for x in stacked])
    outs = []
    for i, device in enumerate(devices[:n_use]):
        block = ColumnArrays(*[x[i * per:(i + 1) * per].to(device) for x in stacked])
        with _on(device):
            fb = forward_backward_batch(block) if run_g else None
            states = viterbi(block, uniform) if run_p else None
        outs.append((fb, states))
    posts = corr = states = None
    if run_g:
        posts = np.concatenate([fb[0].cpu().numpy() for fb, _ in outs])[:B]
        corr = np.concatenate([fb[1].cpu().numpy() for fb, _ in outs])[:B]
    if run_p:
        states = np.concatenate([s.cpu().numpy() for _, s in outs])[:B]
    return posts, corr, states
