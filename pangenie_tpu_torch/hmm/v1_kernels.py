"""Wrapper of kernel V1, the phasing Viterbi, in ``csrc/viterbi.cu``.

V1 runs one warp a chain for B chains of N columns at P <= 32 paths (S =
P^2 states) and A <= 32 alleles: the factored max-plus step of
``viterbi.py`` (its plain version) a column, the int16 backtraces of
every state and column written to device memory, and, in the same
launch, the chase from the last column back. With entry and exit
carries and a switch that skips the backtraces (and the chase), it also
runs the checkpointed form, ``viterbi.checkpointed``.

On CPU tensors :func:`sweep` runs the plain version
(``viterbi.segment_plain``); on CUDA tensors it launches V1 or raises —
there is no fallback from the card to the plain version. It checks
device, dtype, shape and contiguity and allocates the outputs; the
kernel allocates nothing. Past 32 paths it raises: no command reaches
that (phasing takes at most 30 paths).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from .._build import CudaKernel, launch_stream
from .viterbi import Inputs, Segment, segment_plain

_P = ctypes.c_void_p
_I = ctypes.c_int
# kernel V1: replaces pangenie_tpu/hmm/viterbi.py:_viterbi_scan (and its
# two-pass form _viterbi_fast; with carries, _viterbi_segment_forward and
# _viterbi_segment_backtrace)
V1 = CudaKernel("viterbi", "pg_v1_viterbi", "v1", [_P] * 10 + [_I] * 4 + [ctypes.c_float, _P])

MAX_PATHS = 32
MAX_ALLELES = 32


def launch(inputs: Inputs, carry, first, state_in=None, backtrace: bool = True,
           kernel=V1, stream=None) -> Segment:
    """One V1 launch on tensors that are V1's (see :func:`sweep`), on
    their device as they are: ``kernel`` is the C entry point (the
    emulated test passes its own, on CPU tensors), ``stream`` defaults to
    a CUDA tensor's current stream."""
    logea, al, lt = inputs
    B, N, A, _ = logea.shape
    P = al.shape[2]
    S = P * P
    dev = logea.device
    carry_out = torch.empty((B, S), dtype=torch.float32, device=dev)
    bt = states = state_out = sin = None
    if backtrace:
        # two spare entries: the chase copies the backtraces in 4-byte words
        bt = torch.empty(B * N * S + 2, dtype=torch.int16, device=dev)
        states = torch.empty((B, N), dtype=torch.int32, device=dev)
        state_out = torch.empty((B,), dtype=torch.int32, device=dev)
        sin = (torch.full((B,), -1, dtype=torch.int32, device=dev) if state_in is None
               else state_in.to(device=dev, dtype=torch.int32).contiguous())
    if stream is None and logea.is_cuda:
        stream = launch_stream(dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    kernel(logea.data_ptr(), al.data_ptr(), lt.data_ptr(), carry.data_ptr(),
           first.data_ptr(), carry_out.data_ptr(), ptr(bt), ptr(sin), ptr(states),
           ptr(state_out), B, N, P, A, ctypes.c_float(-math.log(float(S))), stream)
    return Segment(carry_out, states, state_out,
                   None if bt is None else bt[:B * N * S].view(B, N, S))


def _check(name, t, dtype, shape, device):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"V1: {name} must be {dtype} {tuple(shape)} on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"V1: {name} is not contiguous")


def checked_inputs(inputs: Inputs, carry, first):
    """(inputs with int32 alleles, carry, first as int32) as V1 takes
    them; ValueError on anything it does not take."""
    logea, al, lt = inputs
    B, N, P = al.shape
    A = logea.shape[-1]
    dev = logea.device
    if P > MAX_PATHS:
        raise ValueError(f"V1 takes at most {MAX_PATHS} paths (S = {MAX_PATHS ** 2} "
                         f"states), got {P}; phasing runs over at most 30")
    if A > MAX_ALLELES:
        raise ValueError(f"V1 takes at most {MAX_ALLELES} alleles a column, got {A}")
    al = al.to(torch.int32).contiguous()
    first = first.to(torch.int32).contiguous()
    _check("logea", logea, torch.float32, (B, N, A, A), dev)
    _check("al", al, torch.int32, (B, N, P), dev)
    _check("lt", lt, torch.float32, (B, N, 3), dev)
    _check("carry", carry, torch.float32, (B, P * P), dev)
    _check("first", first, torch.int32, (B,), dev)
    return Inputs(logea, al, lt), carry, first


def sweep(inputs: Inputs, carry, first, state_in: Optional[torch.Tensor] = None,
          backtrace: bool = True) -> Segment:
    """One segment of columns from the entry carry [B, S] and ``first``
    [B] (the chain's first column: predecessor 0, backtrace 0): the exit
    carry, and with ``backtrace`` the states [B, N] chased from
    ``state_in`` (None or -1: the last column's last-max argmax) and the
    state before the segment. Kernel V1 on CUDA tensors, the plain
    version (``viterbi.segment_plain``) on CPU tensors."""
    if inputs.logea.device.type == "cpu":
        return segment_plain(inputs, carry, first, state_in, backtrace)
    return launch(*checked_inputs(inputs, carry, first), state_in, backtrace)
