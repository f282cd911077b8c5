"""Kernels K3/K4 of ``pangenie_tpu_torch/csrc/fb.cu`` run on the CPU by
an emulator of the CUDA threads, against their plain versions.

The kernel source is compiled with g++ against the headers of
``tests/cuda_emulator/``, which stand in for ``cuda_runtime.h`` and
``csrc/cp_async.cuh``: a cp.async is a plain copy (a 16-byte one must be
16-byte aligned), the dynamic shared memory is one array, and the one
textual substitution makes a launch run every thread of every block as
a fiber. So the kernels' own indexing, barriers, lane-masked shuffles
and ring and staging layout run as written, one block at a time; their
timing and the asynchrony of the copies are not modelled.
``tests/test_torch_cuda_kernels.py`` holds the real kernels against the
same inputs on the card.
"""

import ctypes
import os
import re
import subprocess

import numpy as np
import pytest
import torch

from pangenie_tpu_torch import _build
from pangenie_tpu_torch.hmm import fb_generic, fb_kernels
from test_torch_cuda_kernels import _edge_inputs, _posteriors_close_or_zero

HERE = os.path.dirname(os.path.abspath(__file__))


def _emulated_source(src: str) -> str:
    src, n = re.subn(
        r"kernel<<<B, threads, smem, \(cudaStream_t\)stream>>>\(args\.\.\.\);",
        "if (emu_run(B, threads, smem, [&]() { kernel(args...); }))"
        " return (int)cudaErrorInvalidValue;", src)
    assert n == 1, "the launch in csrc/fb.cu changed"
    return src


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """csrc/fb.cu built against the emulator, its K3/K4 entry points bound."""
    out = tmp_path_factory.mktemp("fb_emulated")
    src = out / "fb_emulated.cpp"
    with open(os.path.join(_build.CUDA_SRC_DIR, "fb.cu")) as f:
        src.write_text(_emulated_source(f.read()))
    lib = out / "libfb_emulated.so"
    subprocess.run(
        ["g++", "-std=c++17", "-O1", "-shared", "-fPIC", "-Wno-unknown-pragmas",
         "-I", os.path.join(HERE, "cuda_emulator"), "-o", str(lib),
         os.path.join(HERE, "cuda_emulator", "emu.cpp"), str(src)],
        check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib))
    lib.pg_fbe_forward.argtypes = fb_kernels.K3._argtypes
    lib.pg_fbe_backward.argtypes = fb_kernels.K4._argtypes
    return lib


def _forward(lib, E, u, alpha0):
    B, n, P, _ = E.shape
    alphas = torch.full((B, n, P, P), float("nan"))
    c_fwd = torch.full((B, n), float("nan"))
    assert lib.pg_fbe_forward(E.data_ptr(), u.data_ptr(), alpha0.data_ptr(),
                              alphas.data_ptr(), c_fwd.data_ptr(), B, n, P,
                              *fb_kernels.generic_launch(P), None) == 0
    return alphas, c_fwd


def _backward(lib, alphas, c_fwd, E, u, e_after, u_after, is_last, beta0):
    B, n, P, _ = E.shape
    last = is_last.to(torch.int32).contiguous()
    posts = torch.full((B, n, P, P), float("nan"))
    beta_out = torch.full((B, P, P), float("nan"))
    assert lib.pg_fbe_backward(alphas.data_ptr(), c_fwd.data_ptr(), E.data_ptr(),
                               u.data_ptr(), e_after.data_ptr(), u_after.data_ptr(),
                               last.data_ptr(), beta0.data_ptr(), posts.data_ptr(),
                               beta_out.data_ptr(), B, n, P,
                               *fb_kernels.generic_launch(P), None) == 0
    return posts, beta_out


@pytest.mark.parametrize("P,n", [(1, 9), (17, 1), (33, 9), (89, 7), (113, 4)])
def test_emulated_generic_kernels_match_plain(emulated, P, n):
    """The card test's inputs (is_last inside the chunk, an all-zero E
    column, padding, an all-padding chain) through the emulated K3/K4:
    close to the plain versions at the card's tolerance, and two
    launches give the same bits. The columns start at every 16-byte
    misalignment (P^2 odd)."""
    E, u, alpha0, e_after, u_after, is_last, beta0 = _edge_inputs(P, n, "cpu")
    a_k, c_k = _forward(emulated, E, u, alpha0)
    a_p, c_p = fb_generic.forward_e_plain(E, u, alpha0)
    torch.testing.assert_close(a_k, a_p, rtol=2e-4, atol=1e-7)
    torch.testing.assert_close(c_k, c_p, rtol=2e-4, atol=1e-7)
    args = (a_k, c_k, E, u, e_after, u_after, is_last, beta0)
    p_k, b_k = _backward(emulated, *args)
    p_p, b_p = fb_generic.backward_e_plain(*args)
    _posteriors_close_or_zero(p_k, p_p)
    torch.testing.assert_close(b_k, b_p, rtol=2e-4, atol=1e-7)
    a_2, c_2 = _forward(emulated, E, u, alpha0)
    p_2, b_2 = _backward(emulated, *args)
    assert torch.equal(a_2, a_k) and torch.equal(c_2, c_k)
    assert torch.equal(p_2, p_k) and torch.equal(b_2, b_k)


def test_emulated_kernels_with_a_ring_of_two(emulated):
    """The ring of two slots at a chunk whose columns outnumber it
    several times."""
    assert fb_kernels.RING == 2
    rng = np.random.default_rng(5)
    B, n, P = 2, 11, 21
    E = torch.from_numpy(rng.random((B, n, P, P)).astype(np.float32))
    u = fb_generic.factor_trans(
        torch.from_numpy(rng.random((B, n, 3)).astype(np.float32)) * 0.1).contiguous()
    ones = torch.ones((B, P, P))
    a_k, c_k = _forward(emulated, E, u, ones)
    a_p, c_p = fb_generic.forward_e_plain(E, u, ones)
    torch.testing.assert_close(a_k, a_p, rtol=2e-4, atol=1e-7)
    torch.testing.assert_close(c_k, c_p, rtol=2e-4, atol=1e-7)


def test_emulated_launch_rejects_another_layout(emulated):
    """fbe_config_ok refuses shared-memory sizes that do not match the
    kernel's layout (the wrapper passes generic_launch's)."""
    E, u, alpha0 = torch.ones((1, 2, 8, 8)), torch.zeros((1, 2, 3)), torch.ones((1, 8, 8))
    out, c = torch.empty_like(E), torch.empty((1, 2))
    threads, smem = fb_kernels.generic_launch(8)
    one_slot = 4 * (8 + 68)                 # header + a P=8 column at any misalignment
    for bad in ((threads, smem + 4), (threads, smem - one_slot), (threads // 2, smem)):
        code = emulated.pg_fbe_forward(E.data_ptr(), u.data_ptr(), alpha0.data_ptr(),
                                       out.data_ptr(), c.data_ptr(), 1, 2, 8, *bad, None)
        assert code != 0
