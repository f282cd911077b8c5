"""Wrappers of the forward-backward kernels in ``csrc/fb.cu``: K1
(forward) and K2 (backward) on [A, A] emissions, K3 (forward) and K4
(backward) on precomputed [P, P] state emissions.

On CPU tensors each wrapper runs its plain torch version
(``forward_plain`` / ``backward_plain`` in ``forward_backward.py``,
``forward_e_plain`` / ``backward_e_plain`` in ``fb_generic.py``); on
CUDA tensors it launches the kernel or raises — there is no fallback
from the card to the plain version. The wrappers check device, dtype,
shape and contiguity and allocate the outputs; the kernels allocate
nothing.
"""

from __future__ import annotations

import ctypes

import torch

from .._build import CudaKernel, launch_stream
from .fb_generic import backward_e_plain, forward_e_plain
from .forward_backward import backward_plain, forward_plain

_P = ctypes.c_void_p
_I = ctypes.c_int

# kernel K1: replaces pangenie_tpu/hmm/pallas_fb.py:_fwd_kernel
K1 = CudaKernel("fb", "pg_fb_forward", "fb", [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P])
# kernel K2: replaces pangenie_tpu/hmm/pallas_fb.py:_bwd_kernel
K2 = CudaKernel(
    "fb", "pg_fb_backward", "fb", [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]
)
# kernel K3: replaces pangenie_tpu/hmm/pallas_fb.py:_fwd_kernel_e
K3 = CudaKernel("fb", "pg_fbe_forward", "fb", [_P, _P, _P, _P, _P, _I, _I, _I, _P])
# kernel K4: replaces pangenie_tpu/hmm/pallas_fb.py:_bwd_kernel_e
K4 = CudaKernel(
    "fb", "pg_fbe_backward", "fb",
    [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
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


def _paths_check(P):
    if P > MAX_PATHS:
        raise ValueError(
            f"{P} paths exceed the forward-backward kernels' limit of "
            f"{MAX_PATHS}; sample haplotypes (-x) or use path subsets (-a)"
        )


def _shape_check(ea, allele_local):
    B, N, A, A2 = ea.shape
    P = allele_local.shape[2]
    if A != A2:
        raise ValueError(f"ea must be [B, N, A, A], got {tuple(ea.shape)}")
    _paths_check(P)
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


def forward_e(E, u, alpha0):
    """(alphas [B, n, P, P], c_fwd [B, n]) from precomputed state
    emissions E [B, n, P, P], factored transitions u [B, n, 3] and the
    entry carry alpha0 [B, P, P] — kernel K3 on CUDA tensors."""
    if E.device.type == "cpu":
        return forward_e_plain(E, u, alpha0)
    B, n, P, _ = E.shape
    _paths_check(P)
    dev = E.device
    _check("E", E, torch.float32, (B, n, P, P), dev)
    _check("u", u, torch.float32, (B, n, 3), dev)
    _check("alpha0", alpha0, torch.float32, (B, P, P), dev)
    alphas = torch.empty((B, n, P, P), dtype=torch.float32, device=dev)
    c_fwd = torch.empty((B, n), dtype=torch.float32, device=dev)
    if B and n:
        K3(E.data_ptr(), u.data_ptr(), alpha0.data_ptr(), alphas.data_ptr(),
           c_fwd.data_ptr(), B, n, P, launch_stream(dev))
    return alphas, c_fwd


def backward_e(alphas, c_fwd, E, u, E_after, u_after, is_last, beta0):
    """(raw posteriors [B, n, P, P], outgoing beta [B, P, P]) — kernel
    K4 on CUDA tensors; see :func:`fb_generic.backward_e_plain`."""
    if E.device.type == "cpu":
        return backward_e_plain(alphas, c_fwd, E, u, E_after, u_after, is_last, beta0)
    B, n, P, _ = E.shape
    _paths_check(P)
    last = is_last.to(torch.uint8).contiguous()
    dev = E.device
    _check("alphas", alphas, torch.float32, (B, n, P, P), dev)
    _check("c_fwd", c_fwd, torch.float32, (B, n), dev)
    _check("E", E, torch.float32, (B, n, P, P), dev)
    _check("u", u, torch.float32, (B, n, 3), dev)
    _check("E_after", E_after, torch.float32, (B, P, P), dev)
    _check("u_after", u_after, torch.float32, (B, 3), dev)
    _check("is_last", last, torch.uint8, (B, n), dev)
    _check("beta0", beta0, torch.float32, (B, P, P), dev)
    posts = torch.empty((B, n, P, P), dtype=torch.float32, device=dev)
    beta_out = torch.empty((B, P, P), dtype=torch.float32, device=dev)
    if B and n:
        K4(alphas.data_ptr(), c_fwd.data_ptr(), E.data_ptr(), u.data_ptr(),
           E_after.data_ptr(), u_after.data_ptr(), last.data_ptr(),
           beta0.data_ptr(), posts.data_ptr(), beta_out.data_ptr(), B, n, P,
           launch_stream(dev))
    else:
        beta_out.copy_(beta0)
    return posts, beta_out
