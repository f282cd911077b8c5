"""Wrappers of kernels K1 (forward) and K2 (backward) in ``csrc/fb.cu``.

On CPU tensors each wrapper runs its plain torch version
(``forward_plain`` / ``backward_plain``); on CUDA tensors it launches
the kernel or raises — there is no fallback from the card to the plain
version. The wrappers check device, dtype, shape and contiguity and
allocate the outputs; the kernels allocate nothing.
"""

from __future__ import annotations

import ctypes

import torch

from .._build import CudaKernel, launch_stream
from .forward_backward import backward_plain, forward_plain

_P = ctypes.c_void_p
_I = ctypes.c_int

# kernel K1: replaces pangenie_tpu/hmm/pallas_fb.py:_fwd_kernel
K1 = CudaKernel("fb", "pg_fb_forward", "fb", [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P])
# kernel K2: replaces pangenie_tpu/hmm/pallas_fb.py:_bwd_kernel
K2 = CudaKernel(
    "fb", "pg_fb_backward", "fb", [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]
)

# a CTA's 256 threads compute the P row sums and P column sums in parallel
MAX_PATHS = 128


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _shape_check(ea, allele_local):
    B, N, A, A2 = ea.shape
    P = allele_local.shape[2]
    if A != A2:
        raise ValueError(f"ea must be [B, N, A, A], got {tuple(ea.shape)}")
    if P > MAX_PATHS:
        raise ValueError(
            f"{P} paths exceed the fused kernels' limit of {MAX_PATHS}; "
            "sample haplotypes (-x) or use path subsets (-a)"
        )
    return B, N, P, A


def forward(ea, allele_local, trans):
    """(alphas [B, N, P, P], c_fwd [B, N]) — kernel K1 on CUDA tensors."""
    if ea.device.type == "cpu":
        return forward_plain(ea, allele_local, trans)
    B, N, P, A = _shape_check(ea, allele_local)
    al = allele_local.to(torch.int32).contiguous()
    dev = ea.device
    _check("ea", ea, torch.float32, (B, N, A, A), dev)
    _check("allele_local", al, torch.int32, (B, N, P), dev)
    _check("trans", trans, torch.float32, (B, N, 3), dev)
    alphas = torch.empty((B, N, P, P), dtype=torch.float32, device=dev)
    c_fwd = torch.empty((B, N), dtype=torch.float32, device=dev)
    if B and N:
        K1(ea.data_ptr(), al.data_ptr(), trans.data_ptr(), alphas.data_ptr(),
           c_fwd.data_ptr(), B, N, P, A, launch_stream(dev))
    return alphas, c_fwd


def backward(alphas, c_fwd, ea, allele_local, trans, is_last):
    """Raw posteriors [B, N, A, A] — kernel K2 on CUDA tensors."""
    if ea.device.type == "cpu":
        return backward_plain(alphas, c_fwd, ea, allele_local, trans, is_last)
    B, N, P, A = _shape_check(ea, allele_local)
    al = allele_local.to(torch.int32).contiguous()
    last = is_last.to(torch.uint8).contiguous()
    dev = ea.device
    _check("alphas", alphas, torch.float32, (B, N, P, P), dev)
    _check("c_fwd", c_fwd, torch.float32, (B, N), dev)
    _check("ea", ea, torch.float32, (B, N, A, A), dev)
    _check("allele_local", al, torch.int32, (B, N, P), dev)
    _check("trans", trans, torch.float32, (B, N, 3), dev)
    _check("is_last", last, torch.uint8, (B, N), dev)
    posts = torch.empty((B, N, A, A), dtype=torch.float32, device=dev)
    if B and N:
        K2(alphas.data_ptr(), c_fwd.data_ptr(), ea.data_ptr(), al.data_ptr(),
           trans.data_ptr(), last.data_ptr(), posts.data_ptr(), B, N, P, A,
           launch_stream(dev))
    return posts
