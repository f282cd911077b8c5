"""Viterbi (phasing, ``-p``) over path-pair states, in torch.

Port of ``pangenie_tpu/hmm/viterbi.py`` (reference src/hmm.cpp:408-511).
The reference's Viterbi scans every previous path pair for every current
one (O(P^4) a column). The pair transition depends only on the number of
paths that switch, so the best predecessor of a state (p1, p2) is the
best of three classes, stay both, switch one and switch both, each found
from the row and column top-2 statistics of the previous column in
O(P^2) (:func:`_prev_best_factored`). Ties are the reference's: its
``>=`` scan over previous states in ascending row-major order keeps the
LAST maximal index, which the factored form reproduces with last-argmax
top-2 statistics and a (value, larger index) combination of the classes
(:func:`_lex_max`). The dense form, :func:`_prev_best_dense`, is kept as
the tests' oracle.

Each column is normalized by subtracting its logsumexp, formed as the
reference package forms it (``jax.scipy.special.logsumexp``: the max, set
to 0 where it is not finite, then the log of the sum of the shifted
``exp``), but in float64 whatever the dtype and rounded to it once, so
that kernel V1 (``csrc/viterbi.cu``), which does the same, gives the same
bits. A column whose logsumexp is not finite becomes uniform at
``-log S``.

Backtraces for every column are kept ([B, N, S]) and the path is chased
back from the last-max argmax of the final column.
:func:`viterbi_segmented` is the checkpointed form (the reference's
sqrt(N) recompute, src/hmm.cpp:119-129): a forward pass over all
segments but the last keeps each segment's entry carry, and a reverse
pass sweeps each segment again with backtraces and chases it from the
state the later segment handed back.

The column loop here (:func:`sweep_plain`, :func:`chase_plain`) is the
plain version of kernel V1 (``v1_kernels.py``): CPU tensors run it, CUDA
tensors run V1 (or raise), in :func:`viterbi` and
:func:`viterbi_segmented` alike. The reference package's ``_viterbi_fast``
(a value-only pass and a 64-column replay that hide the TPU's scan
latency, bit-equal to its scan) is not ported: its scan is the reference
for both forms.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from .emissions import log_emission_allele_matrix
from .forward_backward import ColumnArrays


class Inputs(NamedTuple):
    """V1's inputs for B chains of N columns."""

    logea: torch.Tensor   # [B, N, A, A] log emissions, rescaled
    al: torch.Tensor      # [B, N, P] local allele of each path
    lt: torch.Tensor      # [B, N, 3] log transitions (zeros where uniform)


class Segment(NamedTuple):
    """What a sweep over a segment of columns hands back."""

    carry: torch.Tensor                  # [B, S] normalized values of its last column
    states: Optional[torch.Tensor]       # [B, N] int32 chased states, or None
    state_out: Optional[torch.Tensor]    # [B] int32 state before its first column
    bt: Optional[torch.Tensor] = None    # [B, N, S] backtraces, or None


def _switch_counts(P: int, device=None) -> torch.Tensor:
    """[S, S] number of path switches between state j and state i."""
    ids = torch.arange(P * P, device=device)
    p1, p2 = ids // P, ids % P
    return ((p1[:, None] != p1[None, :]).long()
            + (p2[:, None] != p2[None, :]).long())


def _last_argmax(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The largest index of the maximum along ``dim`` (``torch.argmax``
    promises nothing on ties): the max of the iota where x is the max."""
    n = x.shape[dim]
    shape = [1] * x.ndim
    shape[dim] = n
    idx = torch.arange(n, device=x.device).view(shape)
    m = x.amax(dim, keepdim=True)
    return torch.where(x == m, idx, -1).amax(dim)


def _prev_best_dense(lv_prev, lt, P: int):
    """O(P^4) formulation: (best value, last-max argmax) of
    lv_prev[b, j] + lt[b, switches(j, i)] over previous states j, per
    current state i; lv_prev [B, S], lt [B, 3]. The oracle of
    :func:`_prev_best_factored`."""
    T = lt[:, _switch_counts(P, lt.device)]              # [B, S(j), S(i)]
    scores = lv_prev[:, :, None] + T
    return scores.amax(dim=1), _last_argmax(scores, 1)


def _top2_last(x, dim: int):
    """Per-slice (m1, a1, m2, a2) along ``dim``: the max with its LAST
    argmax, and the max with its last argmax once index a1 is excluded
    (set to -inf), so that (m2, a2) answer "max over the slice but one
    given index" exactly, ties included. Where every other value is
    -inf, a2 is the last index (the excluded slot is -inf too)."""
    n = x.shape[dim]
    shape = [1] * x.ndim
    shape[dim] = n
    idx = torch.arange(n, device=x.device).view(shape)
    m1 = x.amax(dim)
    a1 = torch.where(x == m1.unsqueeze(dim), idx, -1).amax(dim)
    masked = torch.where(idx == a1.unsqueeze(dim), float("-inf"), x)
    m2 = masked.amax(dim)
    a2 = torch.where(masked == m2.unsqueeze(dim), idx, -1).amax(dim)
    return m1, a1, m2, a2


def _lex_max(va, ja, vb, jb):
    """(value, state index)-lexicographic max: the larger value wins, a
    tie goes to the LARGER previous-state index (src/hmm.cpp:464-471)."""
    take_a = (va > vb) | ((va == vb) & (ja > jb))
    return torch.where(take_a, va, vb), torch.where(take_a, ja, jb)


def _prev_best_factored(lv_prev, lt, P: int):
    """Exact O(P^2) factorization of :func:`_prev_best_dense`, per chain
    of the batch (lv_prev [B, S], lt [B, 3]).

    Per current state i = (p1, p2) the best predecessor is the best of
    stay both (j == i), switch one (j shares exactly one coordinate) and
    switch both (j shares neither); each class max comes from top-2 row
    and column statistics of lv_prev, with last-max argmaxes and the
    lexicographic combination of the dense form's ties.
    """
    B = lv_prev.shape[0]
    lv = lv_prev.view(B, P, P)
    p = torch.arange(P, device=lv.device)
    grid_r = p[:, None]                                   # p1
    grid_c = p[None, :]                                   # p2
    lt0, lt1, lt2 = (lt[:, k, None, None] for k in range(3))

    # per-row / per-column top-2 of the previous column's values
    rm1, ra1, rm2, ra2 = _top2_last(lv, 2)                # [B, P] over q2 per q1
    cm1, ca1, cm2, ca2 = _top2_last(lv, 1)                # [B, P] over q1 per q2

    # class 0, stay both: j == i
    v0 = lv + lt0
    j0 = (grid_r * P + grid_c).expand(B, P, P)

    # class 1, switch one: (p1, q2 != p2) or (q1 != p1, p2)
    ex = ra1[:, :, None] == grid_c                        # row max sits AT p2?
    vr = torch.where(ex, rm2[:, :, None], rm1[:, :, None])
    jr = grid_r * P + torch.where(ex, ra2[:, :, None], ra1[:, :, None])
    ey = ca1[:, None, :] == grid_r                        # column max sits AT p1?
    vc = torch.where(ey, cm2[:, None, :], cm1[:, None, :])
    jc = torch.where(ey, ca2[:, None, :], ca1[:, None, :]) * P + grid_c
    v1, j1 = _lex_max(vr, jr, vc, jc)
    v1 = v1 + lt1

    # class 2, switch both: q1 != p1 and q2 != p2. g[q1, p2], the max
    # over q2 != p2 of lv[q1, q2], is vr; its top-2 over q1 per p2
    # answers the q1 != p1 exclusion
    gm1, gA1, gm2, gA2 = _top2_last(vr, 1)                # [B, P] per p2
    hit = gA1[:, None, :] == grid_r                       # top row == p1?
    v2 = torch.where(hit, gm2[:, None, :], gm1[:, None, :]) + lt2
    j2_row = torch.where(hit, gA2[:, None, :], gA1[:, None, :])
    # the winning column: ra2 of row j2_row where that row's best
    # column sits AT p2, else its ra1
    r1g1, r2g1 = ra1.gather(1, gA1), ra2.gather(1, gA1)
    r1g2, r2g2 = ra1.gather(1, gA2), ra2.gather(1, gA2)
    ra1_at = torch.where(hit, r1g2[:, None, :], r1g1[:, None, :])
    ra2_at = torch.where(hit, r2g2[:, None, :], r2g1[:, None, :])
    j2_col = torch.where(ra1_at == grid_c, ra2_at, ra1_at)
    j2 = j2_row * P + j2_col

    best_val, best_idx = _lex_max(v0, j0, v1, j1)
    best_val, best_idx = _lex_max(best_val, best_idx, v2, j2)
    return best_val.reshape(B, P * P), best_idx.reshape(B, P * P)


def _normalize(cur):
    """cur [B, S] minus its logsumexp, or -log S everywhere where that is
    not finite. The logsumexp is the reference package's formula, taken
    in float64 and rounded to cur's dtype once (kernel V1 forms it so)."""
    S = cur.shape[1]
    m = cur.amax(dim=1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m)).double()
    lse = (torch.log(torch.exp(cur.double() - m).sum(dim=1, keepdim=True)) + m).to(cur.dtype)
    return torch.where(torch.isfinite(lse), cur - lse,
                       torch.full_like(cur, -math.log(float(S))))


def _state_log_emission(logea_n, al_n):
    """[B, A, A] log emissions of one column -> [B, S] by the paths'
    alleles (exact copies)."""
    B, A, _ = logea_n.shape
    P = al_n.shape[1]
    rows = torch.gather(logea_n, 1, al_n[:, :, None].expand(B, P, A))    # [B, P, A]
    return torch.gather(rows, 2, al_n[:, None, :].expand(B, P, P)).reshape(B, P * P)


def viterbi_step(lv_prev, is_first, logE, lt, P: int):
    """One column: (normalized values [B, S], backtraces [B, S] int64)
    from the previous column's values ``lv_prev`` [B, S], ``is_first``
    [B] bool (the first column: predecessor 0, backtrace 0), the
    column's state log emissions ``logE`` [B, S] and log transitions
    ``lt`` [B, 3]."""
    best_val, best_idx = _prev_best_factored(lv_prev, lt, P)
    first = is_first[:, None]
    cur = torch.where(first, torch.zeros_like(best_val), best_val) + logE
    return _normalize(cur), torch.where(first, torch.zeros_like(best_idx), best_idx)


def sweep_plain(inputs: Inputs, carry, first, backtrace: bool = True):
    """Plain version of V1's sweep: (exit carry [B, S], backtraces
    [B, N, S] int32 or None) from the entry carry [B, S] and ``first`` [B]
    bool."""
    logea, al, lt = inputs
    B, N = al.shape[:2]
    P = al.shape[2]
    al = al.long()
    lv, isf = carry, first.bool()
    bts = (torch.empty((B, N, P * P), dtype=torch.int32, device=al.device)
           if backtrace else None)
    for n in range(N):
        lv, bt = viterbi_step(lv, isf, _state_log_emission(logea[:, n], al[:, n]),
                              lt[:, n], P)
        isf = torch.zeros_like(isf)
        if backtrace:
            bts[:, n] = bt
    return lv, bts


def chase_plain(bts, last, state_in=None):
    """Plain version of V1's chase: from ``state_in`` [B] where it is >=
    0, else the last-max argmax of the final column's values ``last``
    [B, S] (the reference's ``>=`` over ascending states,
    src/hmm.cpp:132-141), follow the backtraces [B, N, S] back. Returns
    (states [B, N] int32, the state before the first column [B] int32)."""
    B, N = bts.shape[:2]
    state = _last_argmax(last, 1)
    if state_in is not None:
        state = torch.where(state_in >= 0, state_in.long(), state)
    states = torch.empty((B, N), dtype=torch.int32, device=bts.device)
    for n in range(N - 1, -1, -1):
        states[:, n] = state
        state = bts[:, n].gather(1, state[:, None])[:, 0].long()
    return states, state.int()


def segment_plain(inputs: Inputs, carry, first, state_in=None,
                  backtrace: bool = True) -> Segment:
    """Plain version of one V1 launch: the sweep from (carry, first), and
    with ``backtrace`` the chase from ``state_in`` (None or -1: the last
    column's last-max argmax)."""
    last, bts = sweep_plain(inputs, carry, first, backtrace)
    if not backtrace:
        return Segment(last, None, None)
    states, state_out = chase_plain(bts, last, state_in)
    return Segment(last, states, state_out, bts)


def viterbi_inputs(columns: ColumnArrays, uniform: bool = False,
                   length: Optional[int] = None) -> Inputs:
    """V1's inputs from batched columns [B, N, ...]: the log emissions,
    the paths' alleles and the log transitions (zeros where
    ``uniform``). With ``length`` > N, padded to ``length`` columns as
    PairHMM pads a bucket: all-zero emissions (log 0),
    allele 0 and stay-only transitions (1, 0, 0)."""
    logea = log_emission_allele_matrix(
        columns.lp, columns.incidence, columns.kmer_mask, columns.undefined,
        columns.all_zeros, columns.scale,
    )
    al = columns.allele_local
    trans = columns.trans
    B, N = al.shape[:2]
    if length is not None and length > N:
        extra = length - N
        logea = torch.cat([logea, logea.new_zeros((B, extra) + logea.shape[2:])], dim=1)
        al = torch.cat([al, al.new_zeros((B, extra, al.shape[2]))], dim=1)
        pad = trans.new_zeros((B, extra, 3))
        pad[:, :, 0] = 1.0
        trans = torch.cat([trans, pad], dim=1)
    lt = torch.zeros_like(trans) if uniform else torch.log(trans)
    return Inputs(logea, al, lt)


def _segment(inputs: Inputs, carry, first, state_in, backtrace: bool) -> Segment:
    """One segment: the plain version on CPU tensors, kernel V1 on CUDA
    tensors (``v1_kernels.sweep``, which raises on what V1 does not
    take)."""
    from . import v1_kernels

    return v1_kernels.sweep(inputs, carry, first, state_in, backtrace)


def checkpointed(inputs: Inputs, segment: int) -> torch.Tensor:
    """States [B, N] int32 over segments of ``segment`` columns: a
    forward pass without backtraces over every segment but the last
    keeps each one's entry carry; the reverse pass sweeps each segment
    again from it with backtraces and chases it from the state the later
    segment handed back (the last one from its final column's last-max
    argmax). One segment of ``segment`` >= N columns is the plain scan."""
    B, N, P = inputs.al.shape
    dev = inputs.al.device
    dtype = inputs.logea.dtype
    carry = torch.zeros((B, P * P), dtype=dtype, device=dev)
    first = torch.ones((B,), dtype=torch.bool, device=dev)
    bounds = [(lo, min(N, lo + segment)) for lo in range(0, N, segment)]

    def part(lo, hi):
        return Inputs(*(x[:, lo:hi].contiguous() for x in inputs))

    checkpoints = [(carry, first)]
    for lo, hi in bounds[:-1]:
        out = _segment(part(lo, hi), *checkpoints[-1], None, False)
        checkpoints.append((out.carry, torch.zeros_like(first)))
    states = torch.empty((B, N), dtype=torch.int32, device=dev)
    state = None
    for (lo, hi), (carry, first) in zip(bounds[::-1], checkpoints[::-1]):
        out = _segment(part(lo, hi), carry, first, state, True)
        states[:, lo:hi] = out.states
        state = out.state_out
    return states


def viterbi_segmented(columns: ColumnArrays, segment: Optional[int] = None,
                      uniform: bool = False, length: Optional[int] = None,
                      budget: Optional[int] = None) -> torch.Tensor:
    """The checkpointed Viterbi (``pangenie_tpu/hmm/viterbi.py:
    viterbi_segmented``) over batched columns on their device, in
    segments of ``segment`` columns; on a card, ``segment`` None takes
    the longest that the free memory (or ``budget`` bytes) holds
    (:func:`segment_columns`). Returns states [B, N] int32 (N =
    ``length`` where the columns are padded to it)."""
    inputs = viterbi_inputs(columns, uniform, length)
    B, N, P = inputs.al.shape
    if segment is None:
        if inputs.al.device.type != "cuda":
            raise ValueError("viterbi_segmented: give the segment length on the CPU")
        from .sampling import memory_budget

        if budget is None:
            budget = memory_budget(inputs.al.device)
        segment = segment_columns(budget, B, N, P)
    return checkpointed(inputs, max(1, segment))


def viterbi(columns: ColumnArrays, uniform: bool = False, length: Optional[int] = None,
            budget: Optional[int] = None) -> torch.Tensor:
    """Best path-pair state per column, [B, N] int32 (states flattened
    row-major, state = p1 * P + p2), for batched columns [B, N, ...];
    ``length`` pads them first (:func:`viterbi_inputs`).

    CPU tensors take the plain scan in one segment. CUDA tensors take
    kernel V1, in one launch where its backtraces fit the free memory
    (or ``budget`` bytes), else in the longest segments that do
    (:func:`viterbi_segmented`); never the plain version.
    """
    if columns.lp.device.type == "cuda":
        return viterbi_segmented(columns, None, uniform, length, budget)
    inputs = viterbi_inputs(columns, uniform, length)
    return checkpointed(inputs, max(1, inputs.al.shape[1]))


def segment_columns(budget: int, B: int, N: int, P: int) -> int:
    """The most columns a V1 segment may have within ``budget`` bytes:
    its int16 backtraces (B * S * 2 bytes a column), with the states
    [B, N] int32, the entry carries of the segments and their exits
    fixed, and a sixteenth of the budget left for the allocator's
    rounding. Raises RuntimeError where not one column fits."""
    S = P * P
    budget -= budget // 16
    per_column = 2 * B * S
    fixed = 4 * B * N + 16 * B * S + 4
    L = (budget - fixed) // per_column
    if 1 <= L < N:  # the entry carries of ceil(N / L) segments
        L = (budget - fixed - 4 * B * S * -(-N // L)) // per_column
    if L < 1:
        raise RuntimeError(
            f"phasing: one column of {B} x {S} states ({per_column} bytes) does not fit "
            f"the {budget} bytes left after {fixed} fixed")
    return int(min(N, L))
