"""The port's kernel bounds (``hmm/bounds.py``) and the K3/K4 launch
layout (``fb_kernels.generic_launch``), on the CPU.

The bounds are held against values worked by hand at the main paths'
shapes and against the bytes of the tensors the plain versions really
take and return; the launch layout against the shared memory one H100
block can use, for every path count the kernels take.
"""

import numpy as np
import pytest
import torch

from pangenie_tpu_torch.hmm import bounds, fb_generic, fb_kernels


# (work, bytes, least ms) at the main paths' shapes: K1/K2 at the bench
# path's B=2 N=65,536 P=16 A=2, K3/K4 at the SV path's B=1 N=131,072
# P=89, S1 at C=2 N=55,040 P=123
@pytest.mark.parametrize("work,nbytes,ms", [
    # ea 1,048,576 + al 8,388,608 + trans 1,572,864 + alphas 134,217,728
    # + c_fwd 524,288
    (bounds.k1(2, 65536, 16, 2), 146_800_640, 0.0438211),
    # alphas + c_fwd + ea + al + trans + is_last 131,072 + posts 1,048,576
    (bounds.k2(2, 65536, 16, 2), 149_028_864, 0.0444862),
    # E 4,152,885,248 + u 1,572,864 + alpha0 31,684 + alphas 4,152,885,248
    # + c_fwd 524,288: 8.31 GB
    (bounds.k3(1, 131072, 89), 8_307_899_332, 2.4799700),
    # alphas + E + posts 3 x 4,152,885,248, c_fwd 524,288, u 1,572,864,
    # e_after, beta0, beta_out 3 x 31,684, u_after 12, is_last (int32)
    # 524,288
    (bounds.k4(1, 131072, 89), 12_461_372_248, 3.7198126),
    # path_cost 54,159,360 + mask 13,539,840 + switch 440,320 + paths
    # 440,320 + best 8
    (bounds.s1(2, 55040, 123), 68_579_848, 0.0204716),
], ids=["K1", "K2", "K3", "K4", "S1"])
def test_bytes_and_bound_at_main_shapes(work, nbytes, ms):
    assert work.nbytes == nbytes
    got_ms, by = work.bound()
    assert by == "bytes"
    assert got_ms == pytest.approx(ms, rel=1e-6)


def test_operations_bound_when_bytes_are_few():
    assert bounds.Work(nbytes=0, ops=67_000_000).bound() == pytest.approx((0.001, "operations"))


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def test_generic_bytes_match_the_plain_versions_tensors():
    """K3/K4's byte counts are the bytes of what their plain versions
    take and return (is_last as the int32 K4 copies)."""
    B, n, P = 2, 5, 7
    rng = np.random.default_rng(0)

    def rand(*shape):
        return torch.from_numpy(rng.random(shape).astype(np.float32))

    E, alpha0, beta0, e_after, u_after = (rand(B, n, P, P), rand(B, P, P), rand(B, P, P),
                                          rand(B, P, P), rand(B, 3))
    u = fb_generic.factor_trans(rand(B, n, 3)).contiguous()
    last = torch.zeros((B, n), dtype=torch.int32)
    alphas, c_fwd = fb_kernels.forward_e(E, u, alpha0)
    assert bounds.k3(B, n, P).nbytes == _nbytes(E, u, alpha0, alphas, c_fwd)
    posts, beta_out = fb_kernels.backward_e(alphas, c_fwd, E, u, e_after, u_after,
                                            last, beta0)
    assert bounds.k4(B, n, P).nbytes == _nbytes(
        alphas, c_fwd, E, u, e_after, u_after, last, beta0, posts, beta_out)


# P=89: a column of 7,924 floats (P^2 + 3, rounded up to float4s), the
# partials' pitch 104; 4 x (2 x (8 + 7,924) + 7,924 + 16 x 104 + 89 + 68)
@pytest.mark.parametrize("P,launch", [
    (1, (512, 900)), (16, (512, 6_080)), (89, (512, 102_436)),
    (128, (512, 206_208)),
])
def test_generic_launch_at_known_path_counts(P, launch):
    assert fb_kernels.generic_launch(P) == launch


def test_generic_launch_fits_every_path_count():
    """For P = 1..128: 16 warps, an E ring of 2 columns, and ring plus
    staging column plus scratch within one H100 block's 232,448 bytes of
    shared memory."""
    assert fb_kernels.RING == 2
    for P in range(1, fb_kernels.MAX_PATHS + 1):
        threads, smem = fb_kernels.generic_launch(P)
        assert threads == 32 * fb_kernels.WARPS == 512
        column = P * P + 3 + (-(P * P + 3)) % 4          # float4s
        pitch = P + (8 - P) % 32
        assert pitch >= P and pitch % 32 == 8
        assert smem == 4 * (2 * (8 + column) + column + 16 * pitch + P + 68)
        assert smem <= fb_kernels.SMEM_BYTES == 232_448
