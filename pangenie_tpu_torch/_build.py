"""Build-on-first-use for the port's native code.

Two kinds of shared library are compiled from the checkout's sources
into the gitignored ``build/pangenie_tpu_torch/`` directory and loaded
with ctypes: the host k-mer engine (``csrc/kmercount.cpp``, g++) and
the hand-written CUDA kernels (``pangenie_tpu_torch/csrc/*.cu``, nvcc
for ``sm_90a``). Every failure raises; nothing falls back silently.

Concurrent builders (test workers, several processes on one checkout)
serialize on an ``flock`` next to the output and publish the library
with an atomic rename, so a half-written file is never loaded.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import shutil
import subprocess
import time
from typing import Callable, Dict, List, Sequence

PACKAGE_DIR = os.path.dirname(os.path.abspath(__file__))
REPO_ROOT = os.path.dirname(PACKAGE_DIR)
BUILD_DIR = os.path.join(REPO_ROOT, "build", "pangenie_tpu_torch")
CUDA_SRC_DIR = os.path.join(PACKAGE_DIR, "csrc")

# seconds spent compiling and the compiler's report, per built library
# (chip_smoke.py prints both)
build_log: Dict[str, dict] = {}


def build_once(
    source: str, out: str, compile_fn: Callable[[str], subprocess.CompletedProcess],
    headers: Sequence[str] = (),
) -> None:
    """Compile ``source`` into ``out`` unless ``out`` is newer than it
    and than each of ``headers``.

    ``compile_fn(tmp_path)`` runs the compiler with ``tmp_path`` as its
    output; the result is renamed onto ``out``. Raises RuntimeError
    with the compiler's output if the source is missing or the build
    fails.
    """
    if not os.path.exists(source):
        raise RuntimeError(f"native source {source} is missing")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        newest = max(os.path.getmtime(f) for f in [source, *headers])
        if os.path.exists(out) and os.path.getmtime(out) >= newest:
            return
        tmp = f"{out}.{os.getpid()}.tmp"
        t0 = time.monotonic()
        try:
            proc = compile_fn(tmp)
        except (OSError, subprocess.CalledProcessError) as e:
            detail = getattr(e, "stderr", "") or ""
            raise RuntimeError(f"building {out} failed: {e}\n{detail}") from e
        os.replace(tmp, out)
        build_log[os.path.basename(out)] = {
            "seconds": time.monotonic() - t0,
            "report": (proc.stdout or "") + (proc.stderr or ""),
        }


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin)")


def load_cuda_library(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` for sm_90a (plain C interface, no torch
    headers; it may include the ``csrc/*.cuh`` headers) and load it."""
    source = os.path.join(CUDA_SRC_DIR, name + ".cu")
    out = os.path.join(BUILD_DIR, f"lib{name}.so")
    cmd: List[str] = [
        "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", source,
    ]
    headers = [os.path.join(CUDA_SRC_DIR, f) for f in os.listdir(CUDA_SRC_DIR)
               if f.endswith(".cuh")]
    build_once(
        source, out,
        lambda tmp: subprocess.run(
            [_nvcc(), *cmd, "-o", tmp],
            check=True, capture_output=True, text=True,
        ),
        headers,
    )
    return ctypes.CDLL(out)


def launch_stream(device) -> ctypes.c_void_p:
    """The current stream of ``device``, which must be the current CUDA
    device (the kernels launch there)."""
    import torch

    current = torch.cuda.current_device()
    if device.index is not None and device.index != current:
        raise ValueError(
            f"tensors are on {device} but the current CUDA device is "
            f"cuda:{current}; call torch.cuda.set_device first"
        )
    return ctypes.c_void_p(torch.cuda.current_stream(current).cuda_stream)


class CudaKernel:
    """One C entry point of a CUDA library in ``csrc/``, bound on first
    call, with a count of its launches.

    Every entry point returns a cudaError_t (0 = launched); the library
    exports ``pg_<prefix>_error_string`` to name it. ``launches`` grows
    by one per successful launch, and nowhere else.
    """

    def __init__(self, library: str, symbol: str, error_prefix: str, argtypes):
        self.library = library
        self.symbol = symbol
        self._error_symbol = f"pg_{error_prefix}_error_string"
        self._argtypes = argtypes
        self._fn = None
        self._lib = None
        self.launches = 0

    def lib(self) -> ctypes.CDLL:
        if self._lib is None:
            lib = load_cuda_library(self.library)
            fn = getattr(lib, self.symbol)
            fn.argtypes = self._argtypes
            fn.restype = ctypes.c_int
            getattr(lib, self._error_symbol).restype = ctypes.c_char_p
            getattr(lib, self._error_symbol).argtypes = [ctypes.c_int]
            self._fn, self._lib = fn, lib
        return self._lib

    def __call__(self, *args) -> None:
        self.lib()
        code = self._fn(*args)
        if code != 0:
            name = getattr(self._lib, self._error_symbol)(code).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {code} ({name})")
        self.launches += 1
