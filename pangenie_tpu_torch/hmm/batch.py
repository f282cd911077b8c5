"""Batched forward-backward dispatch.

Single entry point for a [B, N, ...] batch of independent
forward-backward problems (port of ``pangenie_tpu/hmm/batch.py``).
CPU tensors take the plain torch version (``torch_ref``); CUDA tensors
take kernels K1/K2 (``cuda_fused``), which raise on a shape or dtype
they do not take — the card never falls back to the plain version.
"""

from __future__ import annotations

from . import fb_kernels
from .forward_backward import (
    ColumnArrays,
    allele_emissions,
    forward_backward,
    log_correction,
)

# which implementation the most recent forward_backward_batch call
# chose: "torch_ref" | "cuda_fused". The genotyping driver logs it so a
# lost fast path is visible in run logs.
last_dispatch: str = "none"


def forward_backward_batch(columns: ColumnArrays):
    """Run B independent forward-backward sweeps.

    Returns (posteriors [B, N, A, A], log_correction [B, N]) — see
    :func:`forward_backward.forward_backward`.
    """
    global last_dispatch
    device = columns.lp.device
    if device.type == "cpu":
        last_dispatch = "torch_ref"
        return forward_backward(columns)
    if device.type != "cuda":
        raise ValueError(f"forward_backward_batch: unsupported device {device}")
    last_dispatch = "cuda_fused"
    ea = allele_emissions(columns)
    alphas, c_fwd = fb_kernels.forward(ea, columns.allele_local, columns.trans)
    posts = fb_kernels.backward(
        alphas, c_fwd, ea, columns.allele_local, columns.trans, columns.is_last
    )
    return posts, log_correction(columns.scale)
