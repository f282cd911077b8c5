"""Least device times of the port's kernels on one NVIDIA H100 SXM.

A kernel's bound is the larger of two times: the bytes its function
must move (each input read once, each output written once, at the dtypes
the kernel takes) over the card's memory rate, and the operations it
does over the card's float32 rate outside the tensor cores (NVIDIA's
data sheet, at the full 700 W power limit). No kernel here ends a loop
early or skips work by the data, so both counts follow from the shapes.
``chip_smoke.py`` prints each kernel's bound beside its measured time.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

# float operations per [P, P] state cell and column. Forward (K1, K3):
# the mix (5), the emission product (1), row, column and total sums (3)
# and the normalization (1). Generic backward (K4): the helper product
# (1) and its three sums (3), the mix (5), the total of cur (1), the
# normalization (1) and the posterior alpha * cur * c_fwd (2). K2 adds
# the collapse to allele pairs (1).
FWD_OPS, BWD_E_OPS, BWD_OPS = 10, 13, 14
# integer operations per path and column of one sampling DP iteration:
# the path's cost, staying or switching, the column minimum, the mask
S1_OPS = 4


class Work(NamedTuple):
    nbytes: int
    ops: int

    def bound(self) -> Tuple[float, str]:
        """(least ms, what bounds it: "bytes" or "operations")."""
        byte_ms = self.nbytes / HBM_BYTES_PER_S * 1e3
        op_ms = self.ops / FP32_OPS_PER_S * 1e3
        return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms, "operations")


def k1(B: int, N: int, P: int, A: int) -> Work:
    """fb_forward: ea [B, N, A, A], allele_local (int32) [B, N, P], trans
    [B, N, 3] in; alphas [B, N, P, P], c_fwd [B, N] out."""
    cols, cells = B * N, B * N * P * P
    return Work(4 * (cols * A * A + cols * P + 3 * cols) + 4 * (cells + cols),
                FWD_OPS * cells)


def k2(B: int, N: int, P: int, A: int) -> Work:
    """fb_backward: alphas, c_fwd, ea, allele_local (int32), trans,
    is_last (1 byte) in; posteriors [B, N, A, A] out."""
    cols, cells = B * N, B * N * P * P
    return Work(4 * (cells + cols + cols * A * A + cols * P + 3 * cols) + cols
                + 4 * cols * A * A, BWD_OPS * cells)


def k3(B: int, N: int, P: int) -> Work:
    """fbe_forward: E [B, N, P, P], u [B, N, 3], alpha0 [B, P, P] in;
    alphas [B, N, P, P], c_fwd [B, N] out."""
    cols, cells = B * N, B * N * P * P
    return Work(4 * (cells + 3 * cols + B * P * P) + 4 * (cells + cols),
                FWD_OPS * cells)


def k4(B: int, N: int, P: int) -> Work:
    """fbe_backward: alphas, c_fwd, E, u, e_after [B, P, P], u_after
    [B, 3], is_last (int32, as the kernel copies it), beta0 [B, P, P] in;
    posts [B, N, P, P], beta_out [B, P, P] out."""
    cols, cells, carry = B * N, B * N * P * P, B * P * P
    return Work(4 * (2 * cells + cols + 3 * cols + 2 * carry + 3 * B + cols)
                + 4 * (cells + carry), BWD_E_OPS * cells)


def s1(C: int, N: int, P: int) -> Work:
    """viterbi_iteration: path_cost (int32) [C, N, P], mask (1 byte)
    [C, N, P], switch (int32) [C, N] in; paths (int32) [C, N], best
    (int32) [C] out. The backtrace the kernel keeps is its own scratch,
    not counted. Integer operations count at the float32 rate."""
    return Work(5 * C * N * P + 4 * C * N + 4 * C * N + 4 * C, S1_OPS * C * N * P)
