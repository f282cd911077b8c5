"""Forward-backward pair HMM: column arrays and the plain torch version.

Port of ``pangenie_tpu/hmm/forward_backward.py:forward_backward``
(reference src/hmm.cpp:175-405). The P^2 path-pair state is a [B, P, P]
tensor per column; the rank-1 Li-Stephens transition is the
row-sum / column-sum / total mix. Each column is normalized to sum 1,
with the underflow -> uniform 1/P^2 fallback (c_fwd = 1 there), the
first column starts from all-ones, ``is_last`` re-seeds the backward
pass with ones, and the raw posterior is alpha * cur * c_fwd, collapsed
to [A, A] allele pairs.

The column loops here are the plain version of kernels K1 (forward) and
K2 (backward) in ``csrc/fb.cu``: the CPU path runs them, and the card
holds the kernels against them.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .emissions import log_emission_allele_matrix


class ColumnArrays(NamedTuple):
    """Stacked per-column inputs (leading dims [..., N])."""

    lp: torch.Tensor            # [..., N, K, 3]
    incidence: torch.Tensor     # [..., N, K, A] kmer-on-allele (local ids)
    kmer_mask: torch.Tensor     # [..., N, K]
    alleles: torch.Tensor       # [..., N, P] global allele ids
    undefined: torch.Tensor     # [..., N, A] local allele undefined
    all_zeros: torch.Tensor     # [..., N]
    scale: torch.Tensor         # [..., N]
    trans: torch.Tensor         # [..., N, 3]; trans[n] = t(n-1 -> n)
    allele_local: torch.Tensor  # [..., N, P] local allele index per path
    nr_local: torch.Tensor      # [..., N]
    is_last: torch.Tensor       # [..., N] True at the last real column


_FLOAT_FIELDS = ("lp", "scale", "trans")


def columns_from_numpy(cols, device, dtype) -> ColumnArrays:
    """The reference package's ColumnArrays (numpy or array leaves) ->
    the port's, on ``device``. Float leaves take ``dtype``; integer and
    bool leaves keep their numpy dtype (path/allele indices as int64,
    torch's index type)."""
    out = {}
    for name in ColumnArrays._fields:
        x = np.asarray(getattr(cols, name))
        if name in _FLOAT_FIELDS:
            t = torch.as_tensor(x).to(device=device, dtype=dtype)
        elif name in ("alleles", "allele_local", "nr_local"):
            t = torch.as_tensor(x.astype(np.int64)).to(device)
        else:
            t = torch.as_tensor(x).to(device)
        out[name] = t
    return ColumnArrays(**out)


def allele_emissions(columns: ColumnArrays) -> torch.Tensor:
    """Linear [B, N, A, A] emissions, hoisted out of the column loop."""
    return torch.exp(
        log_emission_allele_matrix(
            columns.lp, columns.incidence, columns.kmer_mask,
            columns.undefined, columns.all_zeros, columns.scale,
        )
    )


def _state_emission(ea, al):
    """[B, A, A] linear emission -> [B, P, P] via the path->allele gather
    (the gather form of the reference package's one-hot expansion)."""
    B, A, _ = ea.shape
    P = al.shape[1]
    rows = torch.gather(ea, 1, al[:, :, None].expand(B, P, A))        # [B,P,A]
    return torch.gather(rows, 2, al[:, None, :].expand(B, P, P))      # [B,P,P]


def _mix_previous(alpha, t):
    """Rank-1-factorized transition mix (src/hmm.cpp:232-234), t [B, 3]."""
    h_i = alpha.sum(dim=2, keepdim=True)       # [B, P, 1] row sums
    h_j = alpha.sum(dim=1, keepdim=True)       # [B, 1, P] col sums
    h_ij = alpha.sum(dim=(1, 2))[:, None, None]
    t0 = t[:, 0, None, None]
    t1 = t[:, 1, None, None]
    t2 = t[:, 2, None, None]
    return t0 * alpha + t1 * (h_i + h_j - 2.0 * alpha) + t2 * (h_ij - h_i - h_j + alpha)


def _normalize(cur, P):
    s = cur.sum(dim=(1, 2))
    pos = (s > 0)[:, None, None]
    normed = torch.where(
        pos, cur / torch.where(pos, s[:, None, None], 1.0),
        torch.full_like(cur, 1.0 / (P * P)),
    )
    return normed, torch.where(s > 0, s, torch.ones_like(s))


def forward_plain(ea, allele_local, trans):
    """Plain version of kernel K1.

    Args:
      ea: [B, N, A, A] linear emissions.
      allele_local: [B, N, P] int local allele per path.
      trans: [B, N, 3] (stay^2, stay*switch, switch^2); trans[:, 0] unused.

    Returns (alphas [B, N, P, P], c_fwd [B, N]).
    """
    B, N, A, _ = ea.shape
    P = allele_local.shape[2]
    al = allele_local.long()
    alphas = torch.empty((B, N, P, P), dtype=ea.dtype, device=ea.device)
    c_fwd = torch.empty((B, N), dtype=ea.dtype, device=ea.device)
    alpha = None
    for n in range(N):
        E = _state_emission(ea[:, n], al[:, n])
        prev = torch.ones_like(E) if n == 0 else _mix_previous(alpha, trans[:, n])
        alpha, c_fwd[:, n] = _normalize(prev * E, P)
        alphas[:, n] = alpha
    return alphas, c_fwd


def backward_plain(alphas, c_fwd, ea, allele_local, trans, is_last):
    """Plain version of kernel K2: reverse sweep + posterior collapse.

    Column n consumes its successor's emission and transition (n + 1,
    wrapping at the end like ``jnp.roll``; the wrapped value is unused
    at ``is_last``). Returns raw posteriors [B, N, A, A].
    """
    B, N, A, _ = ea.shape
    P = allele_local.shape[2]
    al = allele_local.long()
    one_hot = torch.nn.functional.one_hot(al, A).to(ea.dtype)        # [B,N,P,A]
    posts = torch.empty((B, N, A, A), dtype=ea.dtype, device=ea.device)
    beta = torch.zeros((B, P, P), dtype=ea.dtype, device=ea.device)
    for n in range(N - 1, -1, -1):
        nx = (n + 1) % N
        helper = beta * _state_emission(ea[:, nx], al[:, nx])
        last = is_last[:, n].bool()[:, None, None]
        cur = torch.where(last, torch.ones_like(helper), _mix_previous(helper, trans[:, nx]))
        beta, _ = _normalize(cur, P)
        post = alphas[:, n] * cur * c_fwd[:, n, None, None]
        oh = one_hot[:, n]
        posts[:, n] = torch.einsum("bpa,bpq,bqc->bac", oh, post, oh)
    return posts


def log_correction(scale):
    """scale_n + scale_{n+1} (scale_{N-1} alone at the end)."""
    next_scale = torch.cat([scale[..., 1:], torch.zeros_like(scale[..., :1])], dim=-1)
    return scale + next_scale


def forward_backward(columns: ColumnArrays):
    """Plain batched forward-backward over [B, N, ...] columns.

    Returns (posteriors [B, N, A, A], log_correction [B, N]) in the
    layout of the reference package's ``jax.vmap(forward_backward)``.
    """
    ea = allele_emissions(columns)
    alphas, c_fwd = forward_plain(ea, columns.allele_local, columns.trans)
    posts = backward_plain(
        alphas, c_fwd, ea, columns.allele_local, columns.trans, columns.is_last
    )
    return posts, log_correction(columns.scale)
