"""Any-A forward-backward on precomputed [P, P] state emissions, in N-chunks.

Port of the generic half of ``pangenie_tpu/hmm/pallas_fb.py``
(``forward_backward_batch_pallas_e`` and ``_fb_pallas_e_core``). The
emission of every column is expanded to its [P, P] path-pair states
outside the kernels, A-bucketed (each column pays the emission cost of
its own allele count, :func:`bucketed_state_emissions`); kernels K3
(forward) and K4 (backward, ``csrc/fb.cu``) run the recurrence
on it with an entry carry, and the raw [P, P] posteriors are collapsed
to allele pairs outside again (:func:`bucketed_collapse`).

The carries are what a long chromosome needs:
:func:`forward_backward_chunked` walks N in chunks, so device memory is
O(chunk * P^2), not O(N * P^2). Pass 1 runs K3 over every chunk and
keeps only each chunk's entry alpha; pass 2 goes in reverse, recomputes
a chunk's alphas from its entry, runs K4 with the beta that the
following chunk hands back, and collapses the chunk's posteriors at
once. Emissions and collapse are computed per chunk too.

The transition is mixed in the factored form of the reference
(:func:`factor_trans`): u = (t0 - 2 t1 + t2, t1 - t2, t2), pinned to the
identity (1, 0, 0) at global column 0 with the first chunk's entry all
ones, so later chunks mix their entry with the real transition at their
local column 0 and no column needs a special case.

``forward_e_plain`` and ``backward_e_plain`` are the plain versions of
K3 and K4: the CPU path runs them, and the card holds the kernels
against them.
"""

from __future__ import annotations

import sys
from typing import List, Tuple

import numpy as np
import torch

from .emissions import log_emission_allele_matrix
from .forward_backward import (
    ColumnArrays,
    _normalize,
    _state_emission,
    log_correction,
)

# bound on the [rows, P, P] temporaries of the collapse (elements)
_COLLAPSE_ELEMS = 1 << 26

# beyond this many columns a chain executes alone and chunked (the
# reference streams it in segments of this size); also the chunk cap.
# genotyping.PairHMM and batch.use_generic read it here.
SEGMENT = 1 << 17

# the share of the card's total memory a chunk's working set is sized to
# (pick_chunk)
CHUNK_MEMORY_SHARE = 0.3

# (B, N, chunks) of the most recent forward_backward_chunked call, and
# the chunk it took
last_walk: Tuple[int, int, int] = (0, 0, 0)
last_chunk: int = 0


def factor_trans(trans: torch.Tensor) -> torch.Tensor:
    """[..., N, 3] (t0, t1, t2) -> factored (u0, u1, u2), with the first
    column pinned to the identity mix (1, 0, 0)
    (``pallas_fb.py:_factor_trans``)."""
    t0, t1, t2 = trans[..., 0], trans[..., 1], trans[..., 2]
    u = torch.stack([t0 - 2.0 * t1 + t2, t1 - t2, t2], dim=-1)
    u[..., 0, :] = u.new_tensor([1.0, 0.0, 0.0])
    return u


def _mix_factored(carry, u):
    """u0 * c + u1 * (h_i + h_j) + u2 * h, u [B, 3]
    (``pallas_fb.py:_mix``)."""
    h_i = carry.sum(dim=2, keepdim=True)           # [B, P, 1] row sums
    h_j = carry.sum(dim=1, keepdim=True)           # [B, 1, P] column sums
    h = h_i.sum(dim=1, keepdim=True)               # [B, 1, 1]
    u0, u1, u2 = (u[:, i, None, None] for i in range(3))
    return u0 * carry + u1 * (h_i + h_j) + u2 * h


def forward_e_plain(E, u, alpha0):
    """Plain version of kernel K3.

    Args:
      E: [B, n, P, P] linear state emissions of one chunk.
      u: [B, n, 3] factored transitions (:func:`factor_trans`).
      alpha0: [B, P, P] entry carry (all ones for the first chunk).

    Returns (alphas [B, n, P, P], c_fwd [B, n]).
    """
    B, n, P, _ = E.shape
    alphas = torch.empty_like(E)
    c_fwd = torch.empty((B, n), dtype=E.dtype, device=E.device)
    carry = alpha0
    for s in range(n):
        carry, c_fwd[:, s] = _normalize(_mix_factored(carry, u[:, s]) * E[:, s], P)
        alphas[:, s] = carry
    return alphas, c_fwd


def backward_e_plain(alphas, c_fwd, E, u, E_after, u_after, is_last, beta0):
    """Plain version of kernel K4: reverse sweep over one chunk.

    Column s consumes its successor's emission and transition: E[s + 1]
    and u[s + 1] inside the chunk, ``E_after`` [B, P, P] and ``u_after``
    [B, 3] (the following chunk's first column; zeros after the last
    chunk, where ``is_last`` re-seeds) at the chunk's last column.
    ``beta0`` [B, P, P] is the beta the following chunk handed back
    (zeros for the last chunk).

    Returns (raw posteriors alpha * cur * c_fwd [B, n, P, P], the
    normalized beta after the chunk's first column [B, P, P]).
    """
    B, n, P, _ = E.shape
    posts = torch.empty_like(E)
    beta = beta0
    for s in range(n - 1, -1, -1):
        e_next = E[:, s + 1] if s + 1 < n else E_after
        u_next = u[:, s + 1] if s + 1 < n else u_after
        mixed = _mix_factored(beta * e_next, u_next)
        last = is_last[:, s].bool()[:, None, None]
        cur = torch.where(last, torch.ones_like(mixed), mixed)
        beta, _ = _normalize(cur, P)
        posts[:, s] = alphas[:, s] * cur * c_fwd[:, s, None, None]
    return posts, beta


def column_buckets(nr_local: np.ndarray) -> List[Tuple[int, np.ndarray, np.ndarray]]:
    """Bucketing of flat column indices by allele count rounded up to a
    power of two (``pallas_fb.py:_column_buckets``). Returns
    [(a_bucket, idx, idx_padded)]: padded gather rows repeat idx[0] (a
    member of the same bucket, so its truncated-A computation is valid)
    and are scattered to a dummy row."""
    out = []
    a_b = 2
    max_nr = int(nr_local.max())
    lo = 0
    while lo < max_nr:
        idx = np.nonzero((nr_local > lo) & (nr_local <= a_b))[0]
        if len(idx):
            padded_n = 1 << max(0, int(np.ceil(np.log2(len(idx)))))
            idx_p = np.concatenate(
                [idx, np.full(padded_n - len(idx), idx[0], dtype=np.int64)]
            )
            out.append((a_b, idx, idx_p))
        lo = a_b
        a_b *= 2
    return out


def _flat(columns: ColumnArrays) -> ColumnArrays:
    M = columns.lp.shape[0] * columns.lp.shape[1]
    return ColumnArrays(*[x.reshape((M,) + x.shape[2:]) for x in columns])


def _scatter_rows(M: int, idx: np.ndarray, idx_p: np.ndarray, device) -> torch.Tensor:
    """Scatter targets of a padded gather: the real rows, then the dummy
    row M for the padding."""
    sidx = np.full(len(idx_p), M, dtype=np.int64)
    sidx[: len(idx)] = idx
    return torch.from_numpy(sidx).to(device)


def bucket_allele_emissions(lp, incidence, kmer_mask, undefined, all_zeros, scale):
    """Linear [Mb, a, a] allele-pair emissions of one bucket's gathered
    rows (the allele axis already cut to the bucket's size a)."""
    return torch.exp(log_emission_allele_matrix(
        lp[None], incidence[None], kmer_mask[None], undefined[None],
        all_zeros[None], scale[None],
    ))[0]


def bucketed_state_emissions(columns: ColumnArrays) -> torch.Tensor:
    """Per-column linear [P, P] state emissions, computed A-bucketed
    (``pallas_fb.py:bucketed_state_emissions``).

    Each bucket computes its [A, A] emissions with the allele axis cut to
    its own size and gathers them to the path pairs, E[p, q] =
    EA[al[p], al[q]]: bit for bit the reference's one-hot expansion,
    whose other terms multiply exact zeros. Columns without alleles
    (``nr_local`` 0: padding) keep E = 0.

    Returns E [B, N, P*P] (rescaled by exp(-scale)).
    """
    B, N, P = columns.alleles.shape
    A = columns.incidence.shape[-1]
    M = B * N
    flat = _flat(columns)
    dev = columns.lp.device
    E = torch.zeros((M + 1, P * P), dtype=columns.lp.dtype, device=dev)
    for a_b, idx, idx_p in column_buckets(flat.nr_local.cpu().numpy()):
        g = torch.from_numpy(idx_p).to(dev)
        a_s = min(a_b, A)
        ea = bucket_allele_emissions(
            flat.lp[g], flat.incidence[g][:, :, :a_s], flat.kmer_mask[g],
            flat.undefined[g][:, :a_s], flat.all_zeros[g], flat.scale[g],
        )                                                       # [Mb, a_s, a_s]
        E[_scatter_rows(M, idx, idx_p, dev)] = _state_emission(
            ea, flat.allele_local[g]).reshape(len(idx_p), P * P)
    return E[:M].reshape(B, N, P * P)


def bucketed_collapse(posts: torch.Tensor, columns: ColumnArrays) -> torch.Tensor:
    """Collapse raw [B, N, P, P] posteriors to allele pairs, A-bucketed
    (``pallas_fb.py:bucketed_collapse``):

    posteriors[b, n, a, c] = sum_{p, q: al[p]=a, al[q]=c} posts[b, n, p, q]

    as masked sums, first over p then over q, as the reference orders
    them. Rows go through in slices so the [rows, P, P] temporaries stay
    bounded.
    """
    B, N, P = columns.alleles.shape
    A = columns.incidence.shape[-1]
    M = B * N
    dev = posts.device
    flat_posts = posts.reshape(M, P, P)
    al = columns.allele_local.reshape(M, P)
    out = torch.zeros((M + 1, A, A), dtype=posts.dtype, device=dev)
    step = max(1, _COLLAPSE_ELEMS // (P * P))
    for a_b, idx, idx_p in column_buckets(columns.nr_local.reshape(M).cpu().numpy()):
        a_s = min(a_b, A)
        rows_out = _scatter_rows(M, idx, idx_p, dev)
        for lo in range(0, len(idx_p), step):
            g = torch.from_numpy(idx_p[lo: lo + step]).to(dev)
            p, al_g = flat_posts[g], al[g]
            sel = [(al_g == a).to(posts.dtype) for a in range(a_s)]     # [m, P] each
            rows = torch.stack([(p * s[:, :, None]).sum(dim=1) for s in sel], dim=1)
            res = torch.stack([(rows * s[:, None, :]).sum(dim=2) for s in sel], dim=2)
            out[rows_out[lo: lo + step], :a_s, :a_s] = res
    return out[:M].reshape(B, N, A, A)


def pick_chunk(N: int, P: int, B: int, device: torch.device) -> int:
    """Columns per chunk: at most :data:`SEGMENT`; on CUDA also bounded
    by CHUNK_MEMORY_SHARE of the card's total memory. About five [B,
    chunk, P, P] float32 tensors are live at once in pass 2 (E, alphas,
    posts and the collapse's slice temporaries, with headroom). Float32
    results follow the chunk boundaries, so the chunk is a function of
    the shape and the card alone: free memory, which the caller's cache
    and tensors move, would make a rerun write other numbers
    (:func:`forward_backward_chunked` halves it only where a chunk
    cannot be allocated, and says so)."""
    cap = SEGMENT
    if device.type == "cuda":
        total = torch.cuda.get_device_properties(device).total_memory
        per_col = 5 * B * P * P * 4
        cap = min(cap, max(1, int(total * CHUNK_MEMORY_SHARE) // per_col))
    return max(1, min(N, cap))


def forward_backward_chunked(columns: ColumnArrays, chunk: int = 0):
    """Any-A forward-backward over [B, N] columns in N-chunks of
    ``chunk`` columns (0 = :func:`pick_chunk`); kernels K3/K4 on CUDA
    tensors, their plain versions on CPU tensors. Where a chunk cannot
    be allocated (``torch.cuda.OutOfMemoryError``) the walk starts over
    in chunks of half as many columns, and a line on stderr names the
    chunk it takes.

    Returns (posteriors [B, N, A, A], log_correction [B, N]) as
    :func:`forward_backward.forward_backward` does.
    """
    B, N, P = columns.alleles.shape
    if chunk <= 0:
        chunk = pick_chunk(N, P, B, columns.lp.device)
    while True:
        try:
            return _walk(columns, chunk)
        except torch.cuda.OutOfMemoryError:
            if chunk == 1:
                raise
            print(f"  [generic forward-backward] chunks of {chunk} columns did not fit "
                  f"the card: taking chunks of {chunk // 2}", file=sys.stderr, flush=True)
            chunk //= 2


def _walk(columns: ColumnArrays, chunk: int):
    """:func:`forward_backward_chunked` in chunks of ``chunk`` columns."""
    from . import fb_kernels   # not at the top: fb_kernels imports this module

    global last_walk, last_chunk
    B, N, P = columns.alleles.shape
    dtype, dev = columns.lp.dtype, columns.lp.device
    bounds = [(lo, min(N, lo + chunk)) for lo in range(0, N, chunk)]
    last_walk, last_chunk = (B, N, len(bounds)), chunk
    u = factor_trans(columns.trans).contiguous()

    def part(lo, hi):
        sub = ColumnArrays(*[x[:, lo:hi] for x in columns])
        E = bucketed_state_emissions(sub).reshape(B, hi - lo, P, P)
        return sub, E, u[:, lo:hi].contiguous()

    # pass 1: each chunk's entry alpha (all ones for the first)
    entries = [torch.ones((B, P, P), dtype=dtype, device=dev)]
    for lo, hi in bounds[:-1]:
        _sub, E, u_c = part(lo, hi)
        alphas, _c = fb_kernels.forward_e(E, u_c, entries[-1])
        entries.append(alphas[:, -1].contiguous())
        del alphas, E

    # pass 2, in reverse: recompute the chunk's alphas, sweep back, collapse
    A = columns.incidence.shape[-1]
    posteriors = torch.empty((B, N, A, A), dtype=dtype, device=dev)
    beta = torch.zeros((B, P, P), dtype=dtype, device=dev)
    e_after = torch.zeros((B, P, P), dtype=dtype, device=dev)
    u_after = torch.zeros((B, 3), dtype=dtype, device=dev)
    for i in range(len(bounds) - 1, -1, -1):
        lo, hi = bounds[i]
        sub, E, u_c = part(lo, hi)
        alphas, c_fwd = fb_kernels.forward_e(E, u_c, entries[i])
        posts, beta = fb_kernels.backward_e(
            alphas, c_fwd, E, u_c, e_after, u_after, sub.is_last, beta)
        del alphas
        posteriors[:, lo:hi] = bucketed_collapse(posts, sub)
        del posts
        e_after, u_after = E[:, 0].contiguous(), u_c[:, 0].contiguous()
        del E
    return posteriors, log_correction(columns.scale)
