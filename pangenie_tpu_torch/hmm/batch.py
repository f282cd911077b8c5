"""Batched forward-backward dispatch.

Single entry point for a [B, N, ...] batch of independent
forward-backward problems (port of ``pangenie_tpu/hmm/batch.py``). The
route follows from the batch's shape, on every device:

- the generic route (:mod:`fb_generic`: A-bucketed state emissions, then
  kernels K3/K4 in N-chunks with carries) when the padded allele count
  exceeds ``MAX_FUSED_ALLELES`` — the reference's rule, kept so that both
  packages use the same formulation for the same columns — when the
  chain is longer than ``fb_generic.SEGMENT`` columns, or when it has
  more paths than the fused kernels hold (``fb_kernels.MAX_PATHS``; K3/K4
  take any P);
- the fused route (kernels K1/K2, emission gathered from [A, A] inside
  the kernel) otherwise.

CPU tensors run the plain torch versions of the kernels (``torch_ref``
/ ``torch_generic``); CUDA tensors run the kernels (``cuda_fused`` /
``cuda_generic``), which raise on a shape or dtype they do not take —
the card never falls back to a plain version.
"""

from __future__ import annotations

from . import fb_generic, fb_kernels
from .forward_backward import (
    ColumnArrays,
    allele_emissions,
    forward_backward,
    log_correction,
)

# the reference's cap on the fused route (pangenie_tpu/hmm/batch.py:30)
MAX_FUSED_ALLELES = 8

# which implementation the most recent forward_backward_batch call
# chose: "torch_ref" | "torch_generic" | "cuda_fused" | "cuda_generic".
# The genotype commands log it so a lost fast path is visible in run logs.
last_dispatch: str = "none"


def use_generic(columns: ColumnArrays) -> bool:
    """True when the batch takes the generic (K3/K4) route."""
    A = columns.incidence.shape[-1]
    N = columns.lp.shape[1]
    P = columns.allele_local.shape[-1]
    return (A > MAX_FUSED_ALLELES or N > fb_generic.SEGMENT
            or P > fb_kernels.MAX_PATHS)


def forward_backward_batch(columns: ColumnArrays):
    """Run B independent forward-backward sweeps.

    Returns (posteriors [B, N, A, A], log_correction [B, N]) — see
    :func:`forward_backward.forward_backward`.
    """
    global last_dispatch
    device = columns.lp.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"forward_backward_batch: unsupported device {device}")
    on_card = device.type == "cuda"
    if use_generic(columns):
        last_dispatch = "cuda_generic" if on_card else "torch_generic"
        return fb_generic.forward_backward_chunked(columns)
    if not on_card:
        last_dispatch = "torch_ref"
        return forward_backward(columns)
    last_dispatch = "cuda_fused"
    ea = allele_emissions(columns)
    alphas, c_fwd = fb_kernels.forward(ea, columns.allele_local, columns.trans)
    posts = fb_kernels.backward(
        alphas, c_fwd, ea, columns.allele_local, columns.trans, columns.is_last
    )
    return posts, log_correction(columns.scale)
