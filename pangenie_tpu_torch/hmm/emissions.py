"""Per-column allele-pair emissions, batched over [B, N] (torch).

Port of ``pangenie_tpu/hmm/emissions.py``. The reference builds a dense
[allele x allele] probability matrix per column by multiplying per-kmer
copy-number probabilities (src/emissionprobabilitycomputer.cpp:36-53):

  logEA[a1, a2] = sum_k lp[k, u1 + u2]

with u the kmer x allele incidence. Undefined alleles marginalize over
copy numbers in log space (logaddexp), an ``all_zeros`` column is
uniform (logE = 0), and every column is rescaled by ``-scale``. The
[A, A] matrix is gathered to the [P, P] path-pair states inside the
forward-backward (plain version or kernels K1/K2).

This runs as plain torch on every device: in the reference package too
it runs outside the Pallas kernels, as one parallel pass over columns.
"""

from __future__ import annotations

import math

import torch

# bound on the [chunk, K, A, A] temporaries (elements)
_CHUNK_ELEMS = 1 << 24


def _log_emission_chunk(lp, incidence, kmer_mask, undefined, all_zeros, scale):
    inc = incidence.bool()
    on1 = inc[..., :, :, None]            # [..., K, A, 1]
    on2 = inc[..., :, None, :]            # [..., K, 1, A]
    both = on1 & on2                      # copy number 2
    either = on1 | on2                    # copy number >= 1
    mask = kmer_mask.bool()[..., :, None, None]
    l0, l1, l2 = lp[..., 0], lp[..., 1], lp[..., 2]   # [..., K]

    def col(x):
        return x[..., :, None, None]

    zero = torch.zeros((), dtype=lp.dtype, device=lp.device)
    # defined-defined: select lp[k, c]
    contrib = torch.where(both, col(l2), torch.where(either, col(l1), col(l0)))
    log_dd = torch.where(mask, contrib, zero).sum(dim=-3)          # [..., A, A]

    # one undefined allele: prod_k 0.5 * (p[c] + p[c+1]), c clamped to 1
    log_half = math.log(0.5)
    g0 = torch.logaddexp(l0, l1) + log_half
    g1 = torch.logaddexp(l1, l2) + log_half
    contrib_r = torch.where(either, col(g1), col(g0))
    log_r = torch.where(mask, contrib_r, zero).sum(dim=-3)         # [..., A, A]

    # both undefined: prod_k (p0 + p1 + p2) / 3
    suu_k = torch.logaddexp(torch.logaddexp(l0, l1), l2) - math.log(3.0)
    suu = torch.where(kmer_mask.bool(), suu_k, zero).sum(dim=-1)   # [...]

    und = undefined.bool()
    und1 = und[..., :, None]
    und2 = und[..., None, :]
    log_ea = torch.where(
        und1 & und2, suu[..., None, None], torch.where(und1 | und2, log_r, log_dd)
    )
    return torch.where(
        all_zeros.bool()[..., None, None],
        torch.zeros_like(log_ea),
        log_ea - scale[..., None, None],
    )


def log_emission_allele_matrix(lp, incidence, kmer_mask, undefined, all_zeros, scale):
    """logEA [B, N, A, A] (rescaled by -scale) for batched columns.

    Args:
      lp: [B, N, K, 3] log copy-number probabilities (may hold -inf).
      incidence: [B, N, K, A] kmer-on-allele (bool or 0/1).
      kmer_mask: [B, N, K] valid kmer slots.
      undefined: [B, N, A] local allele is undefined.
      all_zeros: [B, N] column emission is identically zero.
      scale: [B, N] per-column log rescale (subtracted).

    Columns are processed in chunks so the [.., K, A, A] temporaries
    stay bounded at genome-scale N.
    """
    B, N, K, _ = lp.shape
    A = incidence.shape[-1]
    out = torch.empty((B, N, A, A), dtype=lp.dtype, device=lp.device)
    step = max(1, _CHUNK_ELEMS // max(1, B * K * A * A))
    for lo in range(0, N, step):
        sl = slice(lo, min(N, lo + step))
        out[:, sl] = _log_emission_chunk(
            lp[:, sl], incidence[:, sl], kmer_mask[:, sl], undefined[:, sl],
            all_zeros[:, sl], scale[:, sl],
        )
    return out


def emission_scale(log_probs, kmer_mask):
    """Per-column rescale constant scale_n = sum_k max_c lp[k, c].

    Independent of the path subset, so it cancels in the per-variant
    normalization; upper-bounds every emission entry (E' <= 1).
    """
    m = torch.amax(log_probs, dim=-1)
    m = torch.where(kmer_mask.bool() & torch.isfinite(m), m, torch.zeros_like(m))
    return m.sum(dim=-1)
