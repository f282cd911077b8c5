"""Least device times of the port's kernels on one NVIDIA H100 SXM.

A kernel's bound is the larger of two times: the bytes its function
must move (each input read once, each output written once, at the dtypes
the kernel takes) over the card's memory rate, and the operations it
does over the card's float32 rate outside the tensor cores (NVIDIA's
data sheet, at the full 700 W power limit). No kernel here but D1's
ends a loop early or skips work by the data, so both counts follow from
the shapes; D1-count's search is counted at the steps its data needs.
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
# operations per [P, P] state cell and column of the phasing Viterbi
# (V1): its share of the row, column and switch-both top-2 passes (7),
# the three class values and their comparisons and selections (11), the
# emission add (1), the column max (1), the shifted exp and its sum (3,
# in double precision, counted at the float32 rate) and the
# normalization (1)
V1_OPS = 24
# integer operations a window of read k-mer counting (D1) needs at
# least, with its packed words read at once: the forward key (two funnel
# shifts and the 2k-bit mask: 3), its reverse complement (the
# complement, five swap steps of 3 and the shift: 17), the window's
# validity bits (a funnel shift, a mask and a compare: 3) and the
# smaller key (1); and a table read of D1-count's search (a binary
# step: the middle, the compare and the bound; a pair of keys: two
# compares and the select: 3)
D1_WINDOW_OPS = 24
D1_SEARCH_OPS = 3
# integer operations a routed key of D1-count-keys needs before its
# search: the check that it is a k-mer (a shift and a compare) and its
# bucket (a shift)
D1_KEY_OPS = 3
# integer operations a key of D1-route needs: the check that it is a
# k-mer (a shift and a compare), its owner (the tag shift, the split, the
# low bit's mask, the xor, two multiplies, the xor and the modulo: 8), its
# region and bin (two shifts and an or: 3)
D1_ROUTE_OPS = 13


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
    is_last (int32, as the kernel copies it) in; posteriors [B, N, A, A]
    out."""
    cols, cells = B * N, B * N * P * P
    return Work(4 * (cells + cols + cols * A * A + cols * P + 3 * cols + cols)
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
    """viterbi_iteration, at any P: path_cost (int32) [C, N, P], mask (1
    byte) [C, N, P], switch (int32) [C, N] in; paths (int32) [C, N], best
    (int32) [C] out. The backtrace the kernel keeps is its own scratch,
    not counted. Integer operations count at the float32 rate."""
    return Work(5 * C * N * P + 4 * C * N + 4 * C * N + 4 * C, S1_OPS * C * N * P)


def s1_seg(C: int, N: int, P: int, segment: int) -> Work:
    """viterbi_iteration_segmented over segments of ``segment`` columns:
    the same function as :func:`s1`, so the same bytes (each input read
    once; the exit rows, entry rows and backtraces are its own scratch);
    the operations of the forward pass over every segment but the last,
    and of the reverse pass over all."""
    forward = C * P * max(0, N - (N - 1) % segment - 1)
    return Work(s1(C, N, P).nbytes, S1_OPS * (C * N * P + forward))


def s1_chase(C: int, N: int, bt_bytes: int) -> Work:
    """S1's chase alone: the one backtrace entry (``bt_bytes`` each) of a
    column that the path needs, and ends (int32) [C], in; paths (int32)
    [C, N] out. One lookup a column."""
    return Work(bt_bytes * C * N + 4 * C + 4 * C * N, C * N)


def v1(B: int, N: int, P: int, A: int, backtrace: bool = True) -> Work:
    """viterbi (V1): logea [B, N, A, A], al (int32) [B, N, P], lt [B, N,
    3], carry_in [B, S] and first (int32) [B] in; carry_out [B, S] out;
    with ``backtrace`` also the int16 backtraces [B, N, S], written once
    (the chase reads them back; the function's output is the states),
    state_in and state_out (int32) [B] and the states (int32) [B, N]."""
    S = P * P
    cols = B * N
    nbytes = cols * (4 * A * A + 4 * P + 12) + 8 * B * S + 4 * B
    if backtrace:
        nbytes += 2 * cols * S + 4 * cols + 8 * B
    return Work(nbytes, V1_OPS * cols * S)


def _packed(n_bases: int) -> int:
    """Bytes of a flat block of D1: words and vwords (int32)."""
    return 4 * ((n_bases + 15) // 16 + (n_bases + 31) // 32)


def d1_extract(n_bases: int) -> Work:
    """D1-extract over a flat block of T bases: words (int32)
    [ceil(T/16)] and vwords (int32) [ceil(T/32)] in (0.375 bytes a
    base); keys (int64) [T] out. Integer operations count at the float32
    rate."""
    return Work(_packed(n_bases) + 8 * n_bases, D1_WINDOW_OPS * n_bases)


def d1_count(n_bases: int, n_keys: int, search_steps: int) -> Work:
    """D1-count over a flat block of T bases into a table of n keys:
    words and vwords, the table (int64) [n] and counts (int32) [n] in,
    counts out. The directory is the kernel's own lookup structure, its
    size the kernel's choice, so its bytes are not counted.
    ``search_steps``: the table reads the block's valid windows make
    (``device_counter.search_steps``)."""
    return Work(_packed(n_bases) + 8 * n_keys + 8 * n_keys,
                D1_WINDOW_OPS * n_bases + D1_SEARCH_OPS * search_steps)


def d1_count_keys(n_queries: int, n_keys: int, search_steps: int, distinct: int,
                  found: int) -> Work:
    """D1-count-keys over m keys routed to a partition of n keys: the
    keys (int64) [m] in; of the partition's table (int64) [n], the
    entries its ``distinct`` query keys need (one each, at most n); of
    its counts (int32) [n], the ``found`` distinct keys' read and
    written. Where the queries cover the table, that is the whole table
    and every count; a partition far larger than its queries (700 M keys
    for 40 M) is read only where they fall (the directory, as D1-count's,
    not counted). ``search_steps``: the table reads the keys' search
    makes (``device_counter.search_steps``)."""
    return Work(8 * n_queries + 8 * min(n_keys, distinct) + 8 * found,
                D1_KEY_OPS * n_queries + D1_SEARCH_OPS * search_steps)


def d1_route(m: int, m_valid: int, bins: int) -> Work:
    """D1-route over a block of m keys (int64), m_valid of them k-mers,
    into ``bins`` (owner, region) bins: the keys read once; the binned
    keys (int64) [m_valid] and each bin's size (int64) [bins] written
    once."""
    return Work(8 * m + 8 * m_valid + 8 * bins, D1_ROUTE_OPS * m)


def d1_route_passes(m: int, m_valid: int, bins: int, ctas: int) -> int:
    """The bytes D1-route's design moves, beside :func:`d1_route`'s
    least: the keys read by both passes (16 bytes a key), the binned
    keys written; the CTAs' counts (int32 [ctas, bins]) written by pass
    1, read and rewritten by the scan and read by pass 2; the sizes
    written, read by the starts' kernel and the starts written and read
    (int64 [bins] each)."""
    return 16 * m + 8 * m_valid + 4 * 4 * ctas * bins + 4 * 8 * bins
