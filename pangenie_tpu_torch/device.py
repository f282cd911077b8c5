"""Device and dtype rule of the port.

The device comes from the caller or from ``PANGENIE_TORCH_DEVICE``; the
default is ``cuda``. A rank of a process group finds its own card in
``PANGENIE_TORCH_DEVICE``, which ``parallel/distributed.py`` sets. Asking
for CUDA where there is none raises: the port never carries on quietly
on the CPU.

The HMM dtype mirrors the reference package (``commands.py:_hmm_dtype``):
float64 on the CPU, for parity with the reference's long-double math;
float32 on CUDA, the dtype the hand-written kernels take.
"""

from __future__ import annotations

import os
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    name = device or os.environ.get("PANGENIE_TORCH_DEVICE") or "cuda"
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} requested but torch.cuda.is_available() is "
            "False; set PANGENIE_TORCH_DEVICE=cpu to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise RuntimeError(f"unsupported device {name!r}")
    return dev


def hmm_dtype(device: torch.device) -> torch.dtype:
    return torch.float64 if device.type == "cpu" else torch.float32
