"""Haplotype sampling (panel reduction, the ``-x`` mechanism) in torch.

Port of ``pangenie_tpu/hmm/sampling.py:sample_panels_batched``
(reference src/haplotypesampler.cpp:20-314). Each of the ``size``
greedy iterations runs one masked single-path min-plus Viterbi per
chromosome — kernel S1 (``csrc/sampling_dp.cu``: a sweep, past 1024
paths on a thread-block cluster of CTAs a chromosome, then a parallel
chase of the backtraces) on the card, the plain column loop
:func:`viterbi_iteration_plain` on the CPU — then masks the chosen
paths and penalizes their alleles with elementwise torch
(``min(cost + penalty, 25)``, padding columns left alone). Any number
of paths.

The full ``[N, P]`` backtraces stay on the device (uint8 up to 256
paths, 16 bits up to 65,536), so a chromosome is sampled in one sweep
wherever its group's peak (:func:`group_peak_bytes`) fits the device's
free memory (:func:`memory_budget`). A chromosome beyond that runs
through the checkpointed scan, S1-seg
(:func:`viterbi_iteration_segmented`): the same kernels over segments
sized from the free memory (:func:`segment_columns`), with the same
paths.

Scores are uint32 with saturating adds (the reference's overflow
clamps). Torch on the CPU has no uint32 add/min/argmin/compare, so the
plain version computes in int64, saturates explicitly at 0xFFFFFFFF
and builds first-index ties by hand (``torch.argmin`` does not promise
which index it returns on ties). Tie-breaking is the reference's:
first minimum in column minima and in the final column; on stay-vs-
switch ties the switch wins (stay only on strict '<').
"""

from __future__ import annotations

import ctypes
import math
import os
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .._build import CudaKernel, launch_stream
from ..kmers.unique import UniqueKmersRecord

UINT_MAX = 0xFFFFFFFF

_P = ctypes.c_void_p
_I = ctypes.c_int
# kernel S1: replaces pangenie_tpu/hmm/sampling.py:_viterbi_iteration
# (and its blocked form _blocked_viterbi): the sweep, then the chase; with
# entry and exit rows, the checkpointed scan _viterbi_iteration_segmented
S1 = CudaKernel("sampling_dp", "pg_s1_sweep", "s1", [_P] * 9 + [_I] * 4 + [_P])
S1_CHASE = CudaKernel("sampling_dp", "pg_s1_chase", "s1", [_P] * 5 + [_I] * 5 + [_P])
# S1's tiers (csrc/sampling_dp.cu): one CTA up to CTA_PATHS (8 warps of
# 4 paths a lane); above it a cluster of up to CLUSTER_RANKS CTAs a
# chromosome, or up to MAX_RANKS where CLUSTER_RANKS CTAs of 32 warps
# (REGISTER_PATHS paths each) would not hold the paths (up to
# CLUSTER_PATHS); past that one CTA of THREADS threads of ceil(P/1024).
# CLUSTER_RANKS is the source's S1_CLUSTER_RANKS: a library built with
# another (tools/s1_times.py --ranks) is driven with this set to match.
CTA_PATHS = 1024
REGISTER_PATHS = 4096
CLUSTER_RANKS = 8
MAX_RANKS = 16
CLUSTER_PATHS = MAX_RANKS * REGISTER_PATHS
THREADS = 1024


def sweep_layout(P: int):
    """(CTAs a chromosome, warps a CTA, paths a lane, backtrace row) of
    S1's sweep for P paths, as csrc/sampling_dp.cu:sweep_layout derives
    them: one CTA of one warp of ceil(P/32) paths a lane up to 128 paths,
    of ceil(P/128) warps of 4 up to CTA_PATHS; then a cluster whose CTAs
    have the warps of 4 paths a lane that CLUSTER_RANKS CTAs need
    (MAX_RANKS where CLUSTER_RANKS CTAs of 32 warps would not hold the
    paths), as few CTAs as hold the paths, so none holds only padding;
    past CLUSTER_PATHS one CTA of 32 warps of ceil(P/1024). ValueError
    where no instance takes the layout (only with another CLUSTER_RANKS).
    A row holds every CTA's paths, path p at entry p."""
    ranks = 1
    if P <= 128:
        warps, per_lane = 1, -(-P // 32)
    elif P <= CTA_PATHS:
        warps, per_lane = -(-P // 128), 4
    elif P <= CLUSTER_PATHS:
        most = CLUSTER_RANKS if P <= CLUSTER_RANKS * REGISTER_PATHS else MAX_RANKS
        warps, per_lane = -(-P // (128 * most)), 4
        ranks = -(-P // (128 * warps))
        if not 2 <= warps <= 32:
            raise ValueError(f"S1 has no cluster of CTAs of {warps} warps ({P} paths)")
    else:
        warps, per_lane = THREADS // 32, -(-P // THREADS)
    return ranks, warps, per_lane, ranks * 32 * warps * per_lane


def backtrace_dtype(P: int) -> torch.dtype:
    """uint8 backtraces up to 256 paths, 16 bits (uint16 in int16) up to
    65,536, else int32."""
    return torch.uint8 if P <= 256 else torch.int16 if P <= 65536 else torch.int32


def chase_segment(N: int) -> int:
    """Columns per segment of S1's chase: ceil(sqrt(N))."""
    return math.isqrt(N - 1) + 1 if N > 1 else 1


def bulk_emission_costs(records: Sequence[UniqueKmersRecord]) -> np.ndarray:
    """Initial per-allele phred costs, [N, A_max] uint32.

    cost = trunc(-10*log10(fraction of allele kmers with count >= 3)),
    25 if the fraction is 0, 50 for undefined alleles
    (reference src/samplingemissions.cpp:9-32; fraction in float32 as
    the reference uses `float`). Entries for allele ids a record does
    not know stay 0 (they are never indexed).
    """
    N = len(records)
    n_alleles = np.fromiter(
        (max(r.alleles) + 1 if r.alleles else 1 for r in records),
        dtype=np.int64,
        count=N,
    )
    A = max(1, int(n_alleles.max()))

    data_lens = np.fromiter(
        (len(r.allele_data) for r in records), dtype=np.int64, count=N
    )
    rec_of = np.repeat(np.arange(N, dtype=np.int64), data_lens)
    total_e = int(data_lens.sum())
    if total_e:
        flat_allele = np.concatenate(
            [r.allele_data for r in records if len(r.allele_data)]
        ).astype(np.int64)
        if all(r.all_single_allele() for r in records):
            present_flags = np.concatenate(
                [r.kmer_counts for r in records if r.size()]
            ) >= 3
        else:
            present_flags = np.concatenate(
                [
                    np.repeat(r.kmer_counts >= 3, np.diff(r.allele_indptr))
                    for r in records
                    if r.size()
                ]
            )
        keys = rec_of * A + flat_allele
        totals = np.bincount(keys, minlength=N * A).reshape(N, A)
        present = np.bincount(
            keys[present_flags], minlength=N * A
        ).reshape(N, A)
    else:
        totals = np.zeros((N, A), dtype=np.int64)
        present = totals

    # fraction in float32 (the reference uses `float`), log10 in double
    frac = np.ones((N, A), dtype=np.float32)
    has_kmers = totals > 0
    np.divide(
        present.astype(np.float32),
        totals.astype(np.float32),
        out=frac,
        where=has_kmers,
    )
    costs = np.zeros((N, A), dtype=np.uint32)
    positive = frac > 0.0
    with np.errstate(divide="ignore"):
        logcost = np.trunc(-10.0 * np.log10(frac.astype(np.float64)))
    costs[positive] = logcost[positive].astype(np.uint32)
    costs[~positive] = 25
    if np.any(costs[positive] >= 25):
        raise AssertionError("bulk_emission_costs: cost >= 25 for positive fraction")

    # undefined alleles cost 50 (rare; per-record fix-up)
    for n, record in enumerate(records):
        if record.has_undefined_alleles():
            for a, undef in record.alleles.items():
                if undef:
                    costs[n, a] = 50
    mask = (
        np.arange(A)[None, :] < n_alleles[:, None]
    )
    costs = np.where(mask, costs, 0).astype(np.uint32)
    return costs


# ---------------------------------------------------------------------------
# one greedy iteration: kernel S1 and its plain version
# ---------------------------------------------------------------------------


def _first_min(x, idx):
    """(min value, FIRST index of it) along the last dim, int64."""
    val = x.min(dim=-1).values
    first = torch.where(x == val[..., None], idx, x.shape[-1]).min(dim=-1).values
    return val, first


def _sat_add(a, b):
    """uint32 saturating add on int64 tensors holding uint32 values."""
    return torch.clamp_max(a + b, UINT_MAX)


def sweep_plain(path_cost, mask, switch, carry_in=None):
    """Plain version of S1's sweep, batched over C chromosomes.

    Args:
      path_cost: [C, N, P] int32 tensor holding uint32 emission costs.
      mask: [C, N, P] bool, True where the path is still available.
      switch: [C, N] int32 holding uint32 switch costs (entry 0 unused
        without ``carry_in``).
      carry_in: None, or [C, P] uint32 scores (int32 bits or int64) of
        the column before column 0, UMAX where masked, as ``last``
        returns them: column 0 is then an inner column of the scan.

    Returns (backtraces [C, N, P] int32, last [C, P] int64: the last
    column's uint32 scores, UMAX where masked).
    """
    C, N, P = path_cost.shape
    dev = path_cost.device
    cost = path_cost.to(torch.int64) & UINT_MAX
    sw = switch.to(torch.int64) & UINT_MAX
    idx = torch.arange(P, device=dev)
    umax = torch.full((C, P), UINT_MAX, dtype=torch.int64, device=dev)
    if carry_in is None:
        prev = torch.zeros((C, P), dtype=torch.int64, device=dev)
        prev_mask = torch.zeros((C, P), dtype=torch.bool, device=dev)
    else:
        # masked paths carry UMAX, which never stays nor wins below UMAX
        prev = carry_in.to(device=dev, dtype=torch.int64) & UINT_MAX
        prev_mask = torch.ones((C, P), dtype=torch.bool, device=dev)
    bts = torch.empty((C, N, P), dtype=torch.int32, device=dev)
    for n in range(N):
        masked_prev = torch.where(prev_mask, prev, umax)
        first_val, first_id = _first_min(masked_prev, idx)
        is_min = idx == first_id[:, None]
        rest = torch.where(is_min, umax, masked_prev)
        second_val, second_id = _first_min(rest, idx)
        helper_val = torch.where(is_min, second_val[:, None], first_val[:, None])
        helper_id = torch.where(is_min, second_id[:, None], first_id[:, None])
        prev_cell = _sat_add(helper_val, sw[:, n, None])
        take_stay = prev_mask & (prev < prev_cell)
        prev_cell = torch.where(take_stay, prev, prev_cell)
        back = torch.where(take_stay, idx, helper_id)
        if n == 0 and carry_in is None:
            prev_cell = torch.zeros_like(prev_cell)
            back = torch.zeros_like(back)
        m = mask[:, n]
        prev = torch.where(m, _sat_add(prev_cell, cost[:, n]), umax)
        prev_mask = m
        bts[:, n] = back.to(torch.int32)
    return bts, prev


def viterbi_iteration_plain(path_cost, mask, switch, carry_in=None):
    """Plain version of kernel S1 (:func:`sweep_plain`, then the chase
    from the last column's first minimum). Returns (paths [C, N] int32,
    best_scores [C] int64 uint32 values)."""
    bts, last = sweep_plain(path_cost, mask, switch, carry_in)
    best_score, state = _first_min(last, torch.arange(last.shape[1], device=last.device))
    return chase_plain(bts, state)[0], best_score


def chase_plain(bt, ends):
    """Plain version of S1's chase: the path [C, N] int32 back from the
    states ``ends`` [C] at the last column through backtraces ``bt``
    [C, N, >= P] (entry p of a row is path p's predecessor; 16-bit rows
    hold uint16), and state_out [C] int64: the backtrace at column 0 of
    the path's state there."""
    C, N = bt.shape[:2]
    bits = 0xFFFF if bt.dtype == torch.int16 else UINT_MAX
    state = ends.to(torch.int64)
    paths = torch.empty((C, N), dtype=torch.int32, device=bt.device)
    for n in range(N - 1, -1, -1):
        paths[:, n] = state
        state = bt[:, n].gather(1, state[:, None])[:, 0].to(torch.int64) & bits
    return paths, state


def _stream(t, stream):
    """``stream``, or the current stream of a CUDA tensor's device."""
    return launch_stream(t.device) if stream is None and t.is_cuda else stream


class Sweep(NamedTuple):
    bt: Optional[torch.Tensor]          # [C, N, row], or None
    best: torch.Tensor                  # [C] int32 holding uint32 bits
    ends: torch.Tensor                  # [C] int32: the last column's first minimum
    carry_out: Optional[torch.Tensor]   # [C, P] int32 holding uint32 scores, or None


def s1_sweep(path_cost, mask, switch, carry_in=None, carry_out=False, backtraces=True,
             sweep=S1, stream=None) -> Sweep:
    """S1's sweep, from the scores ``carry_in`` ([C, P] int32 holding
    uint32, as ``carry_out`` returns them) where given; ``backtraces``
    False keeps none. ``sweep`` is the C entry point (the emulated test
    passes its own); ``stream`` defaults to the device's current one."""
    C, N, P = path_cost.shape
    row = sweep_layout(P)[3]
    dev = path_cost.device

    def empty(shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device=dev)

    bt = empty((C, N, row), backtrace_dtype(P)) if backtraces else None
    best, ends = empty((C,)), empty((C,))
    out = empty((C, P)) if carry_out else None
    scratch = empty((C, P)) if P > CLUSTER_PATHS else None
    if carry_in is not None:
        carry_in = carry_in.to(device=dev, dtype=torch.int32).contiguous()

    def ptr(t):
        return None if t is None else t.data_ptr()

    sweep(path_cost.data_ptr(), mask.data_ptr(), switch.data_ptr(), ptr(carry_in), ptr(out),
          ptr(bt), best.data_ptr(), ends.data_ptr(), ptr(scratch), C, N, P, row,
          _stream(path_cost, stream))
    return Sweep(bt, best, ends, out)


def s1_chase(bt, ends, P: int, chase=S1_CHASE, stream=None):
    """S1's chase from the states ``ends`` [C] at the last column:
    (path [C, N] int32, state_out [C] int32: the backtrace at column 0 of
    the path's state there), in segments of :func:`chase_segment`
    columns."""
    C, N, row = bt.shape
    L = chase_segment(N)
    dev = bt.device
    maps = torch.empty((C, -(-N // L), P), dtype=torch.int32, device=dev)
    paths = torch.empty((C, N), dtype=torch.int32, device=dev)
    state_out = torch.empty((C,), dtype=torch.int32, device=dev)
    ends = ends.to(dtype=torch.int32).contiguous()
    chase(bt.data_ptr(), ends.data_ptr(), maps.data_ptr(), paths.data_ptr(),
          state_out.data_ptr(), C, N, P, row, L, _stream(bt, stream))
    return paths, state_out


def cluster_fits(P: int) -> int:
    """How many clusters of S1's sweep for P paths (:func:`sweep_layout`)
    the card runs at once, by cudaOccupancyMaxActiveClusters, as the
    sweep checks it before each cluster launch; 0 where the layout is not
    a cluster. RuntimeError with the CUDA error otherwise."""
    fn = S1.lib().pg_s1_cluster_fits
    fn.argtypes = [_I, ctypes.POINTER(_I)]
    clusters = _I(0)
    code = fn(P, ctypes.byref(clusters))
    if code:
        raise RuntimeError(f"pg_s1_cluster_fits: CUDA error {code} "
                           f"({S1.lib().pg_s1_error_string(code).decode()})")
    return clusters.value


def _check_inputs(path_cost, mask, switch):
    """Raises ValueError unless the inputs are S1's: int32 costs, bool
    mask [C, N, P], int32 switch [C, N], contiguous, on one device."""
    C, N, P = path_cost.shape
    dev = path_cost.device
    for name, t, dtype, shape in (
        ("path_cost", path_cost, torch.int32, (C, N, P)),
        ("mask", mask, torch.bool, (C, N, P)),
        ("switch", switch, torch.int32, (C, N)),
    ):
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"{name}: expected {dtype} {shape} on {dev}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")


def viterbi_iteration(path_cost, mask, switch):
    """One masked min-plus Viterbi per chromosome — kernel S1 (sweep and
    chase) on CUDA tensors, :func:`viterbi_iteration_plain` on CPU
    tensors. Any P. Returns (paths [C, N] int32, best [C] int64 uint32
    values)."""
    if path_cost.device.type == "cpu":
        return viterbi_iteration_plain(path_cost, mask, switch)
    C, N, P = path_cost.shape
    _check_inputs(path_cost, mask, switch)
    if not (C and N):  # as the plain version: no columns score 0
        return (torch.empty((C, N), dtype=torch.int32, device=path_cost.device),
                torch.zeros((C,), dtype=torch.int64, device=path_cost.device))
    bt, best, ends, _ = s1_sweep(path_cost, mask, switch)
    return s1_chase(bt, ends, P)[0], best.to(torch.int64) & UINT_MAX


# ---------------------------------------------------------------------------
# S1-seg: the checkpointed scan, for chromosomes beyond one device
# ---------------------------------------------------------------------------


def _segment_sweep(path_cost, mask, switch, carry_in, backtraces: bool, plain: bool) -> Sweep:
    """One segment's sweep from ``carry_in``: kernel S1 on CUDA tensors
    (with the exit row where no backtraces are kept: the forward pass),
    :func:`sweep_plain` on CPU tensors or where ``plain`` asks for it.
    ``best`` as int64 uint32 values."""
    if plain or path_cost.device.type == "cpu":
        bts, last = sweep_plain(path_cost, mask, switch, carry_in)
        best, ends = _first_min(last, torch.arange(last.shape[1], device=last.device))
        return Sweep(bts, best, ends, last)
    _check_inputs(path_cost, mask, switch)
    out = s1_sweep(path_cost, mask, switch, carry_in, carry_out=not backtraces,
                   backtraces=backtraces)
    return out._replace(best=out.best.to(torch.int64) & UINT_MAX)


def viterbi_iteration_segmented(source, C: int, N: int, P: int, segment: int, device,
                                plain: bool = False):
    """One masked min-plus Viterbi per chromosome over segments of
    ``segment`` columns: the checkpointed scan of the reference package
    (``_viterbi_iteration_segmented``), with the paths and scores of
    :func:`viterbi_iteration`.

    ``source(lo, hi)`` returns columns lo..hi-1 of the C chromosomes as
    (path_cost [C, hi-lo, P] int32, mask bool, switch [C, hi-lo] int32)
    on ``device``; a source with a ``prefetch(lo, hi)`` method is told the
    segment it will be asked for next, right after each call. A forward
    pass over every segment but the last keeps only each segment's exit
    scores (S1's sweep without backtraces); the reverse pass sweeps each
    segment again from its entry scores with backtraces and chases it
    from the state the later segment handed back. Only one segment's
    inputs and backtraces are held at a time. Kernel S1 on a card, the
    plain versions on the CPU or where ``plain`` asks for them
    (chip_smoke.py holds the kernels against them on the card).

    Returns (paths [C, N] int32, best [C] int64 uint32 values).
    """
    device = torch.device(device)
    plain = plain or device.type == "cpu"
    bounds = [(lo, min(N, lo + segment)) for lo in range(0, N, segment)]
    order = bounds[:-1] + bounds[::-1]
    prefetch = getattr(source, "prefetch", None)
    fetched = iter(range(len(order)))

    def fetch():
        k = next(fetched)
        inputs = source(*order[k])
        if prefetch is not None and k + 1 < len(order):
            prefetch(*order[k + 1])
        return inputs

    carries = [None]
    for _ in bounds[:-1]:
        carries.append(_segment_sweep(*fetch(), carries[-1], False, plain).carry_out)
    paths = torch.empty((C, N), dtype=torch.int32, device=device)
    state = best = None
    for (lo, hi), carry in zip(bounds[::-1], carries[::-1]):
        bt, seg_best, ends, _ = _segment_sweep(*fetch(), carry, True, plain)
        if state is None:  # the last segment: the last column's first minimum
            state, best = ends, seg_best
        if plain:
            paths[:, lo:hi], state = chase_plain(bt, state)
        else:
            paths[:, lo:hi], state = s1_chase(bt, state, P)
        del bt
    return paths, best


def segment_columns(budget: int, C: int, N: int, P: int, column_bytes: int) -> int:
    """The most columns a segment of :func:`viterbi_iteration_segmented`
    may have within ``budget`` bytes: the source's ``column_bytes`` a
    column (of the C chromosomes), S1's backtraces, the segment's path,
    the chase maps, the whole path and every entry row, with a sixteenth
    of the budget left for the allocator's rounding. Raises RuntimeError
    where not one column fits."""
    budget -= budget // 16
    row = sweep_layout(P)[3]
    bt = torch.empty((), dtype=backtrace_dtype(P)).element_size()
    per_column = column_bytes + C * (row * bt + 8)
    # path [C, N], chase maps (at most isqrt(N) + 2 rows of [C, P]), the
    # sweep's rows and scratch
    fixed = 4 * C * N + 4 * C * P * (math.isqrt(N) + 6)
    L = min(N, (budget - fixed) // per_column)
    if L >= 1:  # the entry rows of ceil(N / L) segments
        L = min(N, (budget - fixed - 4 * C * P * -(-N // L)) // per_column)
    if L < 1:
        raise RuntimeError(
            f"sampling: one column of {C} x {P} paths ({per_column} bytes) does not "
            f"fit the {budget} bytes left after {fixed} fixed")
    return int(L)


# cells of one chunk of _gather_costs' int32 index
GATHER_CELLS = 1 << 24


def _gather_costs(costs, alleles):
    """costs [C, N, A] int32 through alleles [C, N, P] (int32, or uint8
    as the checkpointed route uploads them): [C, N, P]
    int32 path costs, a chromosome and a chunk of columns at a time (at
    most GATHER_CELLS cells, or one column): the chunk's int32 index into
    its flattened costs is the one temporary."""
    C, N, P = alleles.shape
    A = costs.shape[2]
    dev = alleles.device
    out = torch.empty((C, N, P), dtype=torch.int32, device=dev)
    step = max(1, min(GATHER_CELLS // max(1, P), (2**31 - 1) // max(1, A)))
    for c in range(C):
        for lo in range(0, N, step):
            hi = min(N, lo + step)
            at = torch.arange(0, (hi - lo) * A, A, dtype=torch.int32, device=dev)
            index = alleles[c, lo:hi] + at[:, None]
            torch.index_select(costs[c, lo:hi].reshape(-1), 0, index.view(-1),
                               out=out[c, lo:hi].view(-1))
    return out


def sample_group(costs, alleles, switch, valid, size: int, allele_penalty: int,
                 viterbi=viterbi_iteration):
    """Batched greedy sampling over a [C, N] group of chromosomes.

    Port of the reference package's ``_sample_group``.

    Args:
      costs: [C, N, A] int32 initial per-allele emission costs (not
        changed: the loop updates a copy).
      alleles: [C, N, P] int32 path->allele.
      switch: [C, N] int32 per-column switch costs (1 in padding).
      valid: [C, N] bool — False on padding columns (their mask and
        penalty updates are suppressed so they stay neutral).
      viterbi: the per-iteration DP; chip_smoke.py passes the plain
        version to hold kernel S1 against it on the card.

    Each iteration masks the chosen paths and raises the chosen allele's
    cost to min(cost + penalty, 25) (uint32 arithmetic) on every path
    carrying it: the allele's new cost is computed once a column and
    written where the path's allele is the chosen one, in place, so
    that a [C, N, P] cell holds its int32 allele and cost and the used
    flag between iterations, and a selection byte in one.

    Returns [size, C, N] int32 sampled path per iteration.
    """
    C, N, P = alleles.shape
    penalty = int(allele_penalty) & UINT_MAX
    costs = costs.clone()
    path_cost = _gather_costs(costs, alleles)
    used = torch.zeros((C, N, P), dtype=torch.bool, device=alleles.device)
    valid3 = valid[:, :, None]
    out = torch.empty((size, C, N), dtype=torch.int32, device=alleles.device)
    for it in range(size):
        paths, _scores = viterbi(path_cost, ~used, switch)
        out[it] = paths
        at = paths.to(torch.int64)[:, :, None]
        used.scatter_(2, at, valid3)  # padding columns' used stays all False
        chosen = torch.gather(alleles, 2, at)
        old = torch.gather(costs, 2, chosen.long())
        pen = torch.clamp_max(((old.to(torch.int64) & UINT_MAX) + penalty) & UINT_MAX, 25)
        new = torch.where(valid3, pen.to(torch.int32), old)
        costs.scatter_(2, chosen.long(), new)
        sel = alleles == chosen
        sel &= valid3
        torch.where(sel, new, path_cost, out=path_cost)
        # none of this iteration's temporaries lives through the next DP
        del paths, at, chosen, old, pen, new, sel
    return out


def group_peak_bytes(C: int, N: int, P: int, A: int, size: int) -> int:
    """Most bytes that one [C, N] group holds at once on its device in
    :func:`sample_panels_batched`: the tensors it passes to
    :func:`sample_group` and those of ``size`` iterations there.

    Held throughout: costs and their copy (int32, A a column), alleles
    (int32 a cell), switch, valid, the sampled paths, path_cost (int32 a
    cell) and used (a byte a cell). On top, the largest of: S1's mask,
    backtraces, chase maps, path and its int64 copy; the update's
    selection byte a cell and its column temporaries; the first gather's
    int32 index (:data:`GATHER_CELLS` cells at most). (Measured on an H100
    at N=2,300,000, P=123, 2 iterations: 11.42 bytes a cell against this
    model's 11.54, chip_smoke.py.)
    """
    cols, cells = C * N, C * N * P
    row = sweep_layout(P)[3]
    bt = cols * row * torch.empty((), dtype=backtrace_dtype(P)).element_size()
    held = cols * (8 * A + 4 + 1 + 4 * size) + cells * (4 + 4 + 1)
    s1 = cells + bt + 4 * C * -(-N // chase_segment(N)) * P + 16 * cols
    update = cells + 64 * cols
    gather = 4 * min(N * P, max(GATHER_CELLS, P))
    return held + max(s1, update, gather)


def memory_budget(device) -> int:
    """Bytes a sampling group may take on ``device``: the card's free
    memory plus what torch's allocator holds there unused, or the host's
    free memory for the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        free, _total = torch.cuda.mem_get_info(device)
        return free + torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)
    return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")


class _ChromState:
    """Dense per-chromosome sampling state for the batched driver."""

    def __init__(self, chromosome: str, records: Sequence[UniqueKmersRecord],
                 recombrate: float, effective_N: float):
        self.chromosome = chromosome
        self.records = records
        self.N = len(records)
        self.P = records[0].get_nr_paths()
        self.costs = bulk_emission_costs(records)  # [N, A]
        positions = np.fromiter(
            (r.variant_position for r in records), dtype=np.int64,
            count=self.N,
        )
        self.switch = np.zeros(self.N, dtype=np.uint32)
        if self.N > 1:
            LD = np.longdouble
            distance = (
                np.diff(positions).astype(LD)
                * LD(0.000004) * LD(recombrate) * LD(effective_N)
            )
            recomb_prob = (LD(1.0) - np.exp(-distance / LD(self.P))) * (
                LD(1.0) / LD(self.P)
            )
            self.switch[1:] = np.trunc(
                -10.0 * np.log10(recomb_prob)
            ).astype(np.uint32)
        self.sampled_paths: List[List[int]] = []

    def fill_alleles(self, out: np.ndarray) -> np.ndarray:
        """Each record's path -> allele into ``out`` [N, P] (an integer
        dtype that holds every allele id), which it returns."""
        for n, r in enumerate(self.records):
            out[n] = r.path_to_allele
        return out


class _PanelSegments:
    """The source of :func:`viterbi_iteration_segmented` for one long
    chromosome of the batched driver, and its greedy update.

    Alleles (a byte a cell where the ids fit, else int32) and the used
    flags stay on the host, filled straight from the records into one
    pinned array each where the device is a card; the per-allele costs
    too. A segment's alleles, used
    flags, costs and switch are uploaded when the driver asks for it (on
    a card, the segment named by ``prefetch`` is copied on a side stream
    while the current one sweeps) and its path costs gathered on the
    device. The update between iterations runs on the host, as the
    reference package's does: the path's cells become used and the chosen
    allele's cost min(cost + penalty, 25) (uint32 arithmetic)."""

    def __init__(self, st: _ChromState, device):
        self.device = torch.device(device)
        pin = self.device.type == "cuda"
        self.N, self.P, self.A = st.N, st.P, st.costs.shape[1]
        dtype = torch.uint8 if self.A <= 256 else torch.int32
        self.alleles = torch.empty((st.N, st.P), dtype=dtype, pin_memory=pin)
        st.fill_alleles(self.alleles.numpy())
        self.used = torch.zeros((st.N, st.P), dtype=torch.bool, pin_memory=pin)
        self.costs = st.costs.copy()
        self.switch = st.switch
        self.stream = torch.cuda.Stream(self.device) if pin else None
        self.next = None

    # per column: two segments' uploads (the current and the prefetched
    # one), the path costs, the mask and the gather's int32 index
    def column_bytes(self) -> int:
        allele = self.alleles.element_size()
        return 2 * ((allele + 1) * self.P + 4 * self.A + 4) + 9 * self.P

    def _upload(self, lo, hi):
        dev = self.device
        alleles = torch.empty((hi - lo, self.P), dtype=self.alleles.dtype, device=dev)
        used = torch.empty((hi - lo, self.P), dtype=torch.bool, device=dev)
        alleles.copy_(self.alleles[lo:hi], non_blocking=True)
        used.copy_(self.used[lo:hi], non_blocking=True)
        costs = torch.from_numpy(self.costs[lo:hi].view(np.int32)).to(dev)
        switch = torch.from_numpy(self.switch[lo:hi].view(np.int32)).to(dev)
        return alleles, used, costs, switch

    def prefetch(self, lo: int, hi: int) -> None:
        if self.stream is None:
            return
        current = torch.cuda.current_stream(self.device)
        # the destinations belong to the current stream, which waits for
        # the copies before it reads them
        with torch.cuda.stream(self.stream):
            self.stream.wait_stream(current)
            self.next = (lo, hi), self._upload(lo, hi), torch.cuda.Event()
            self.next[2].record(self.stream)

    def __call__(self, lo: int, hi: int):
        if self.next is not None and self.next[0] == (lo, hi):
            _bounds, (alleles, used, costs, switch), done = self.next
            torch.cuda.current_stream(self.device).wait_event(done)
        else:
            alleles, used, costs, switch = self._upload(lo, hi)
        self.next = None
        path_cost = _gather_costs(costs[None], alleles[None])
        return path_cost, ~used[None], switch[None].contiguous()

    def update(self, path: np.ndarray, penalty: int) -> None:
        cols = np.arange(self.N)
        self.used.numpy()[cols, path] = True
        chosen = self.alleles.numpy()[cols, path]
        old = self.costs[cols, chosen].astype(np.int64)
        self.costs[cols, chosen] = np.minimum((old + (penalty & UINT_MAX)) & UINT_MAX, 25)


def _sample_long(st: _ChromState, size: int, allele_penalty: int, budget: int,
                 device) -> None:
    """``size`` greedy iterations of one chromosome through
    :func:`viterbi_iteration_segmented`, in the longest segments that fit
    ``budget``."""
    source = _PanelSegments(st, device)
    segment = segment_columns(budget, 1, st.N, st.P, source.column_bytes())
    for _ in range(size):
        paths, _best = viterbi_iteration_segmented(source, 1, st.N, st.P, segment, device)
        path = paths[0].cpu().numpy()
        st.sampled_paths.append(path.tolist())
        source.update(path, int(allele_penalty))


def _write_paths(records, sampled_paths, path_output: str, chromosome: str) -> None:
    """Per-column sampled path/recombination TSV
    (reference src/haplotypesampler.cpp:45-66)."""
    S = len(sampled_paths)
    N = len(records)
    header = "#chromosome\tposition" + "".join(
        f"\tHaplotypeID_path{p}\tRecombination_path{p}" for p in range(S)
    )
    sampled = np.asarray(sampled_paths, dtype=np.int64)  # [S, N]
    recomb = np.zeros_like(sampled)
    if N > 1:
        recomb[:, 1:] = (np.diff(sampled, axis=1) != 0).astype(np.int64)
    body = np.empty((N, 1 + 2 * S), dtype=np.int64)
    body[:, 0] = np.fromiter(
        (r.get_variant_position() for r in records),
        dtype=np.int64, count=N,
    )
    body[:, 1::2] = sampled.T
    body[:, 2::2] = recomb.T
    prefix = chromosome + "\t"
    lines = [
        prefix + "\t".join(map(str, row)) for row in body.tolist()
    ]
    with open(path_output, "w") as out:
        out.write(header + "\n")
        out.write("\n".join(lines))
        if lines:
            out.write("\n")


def _group_peak(group, size: int) -> int:
    return group_peak_bytes(len(group), max(s.N for s in group), group[0].P,
                            max(s.costs.shape[1] for s in group), size)


def plan_groups(states, size: int, max_group_bytes: int, budget: int):
    """(groups, long states): chromosomes of similar length (padded N
    within 2x; ``states`` in order of N) in groups under
    ``max_group_bytes`` of [C, N, P] int32 costs and whose peak
    (:func:`group_peak_bytes`) fits ``budget`` bytes; and, apart, the
    chromosomes whose peak alone exceeds the budget, for the checkpointed
    scan."""
    long_states = [st for st in states if _group_peak([st], size) > budget]
    groups: List[List[_ChromState]] = []
    for st in states:
        if st in long_states:
            continue
        Npad = 1 << max(0, (st.N - 1).bit_length())
        if groups:
            cur = groups[-1]
            cur_pad = 1 << max(0, (cur[0].N - 1).bit_length())
            pad_target = max(cur_pad, Npad)
            bytes_needed = (
                (len(cur) + 1) * pad_target * st.P * 4
            )
            if (1 << max(0, (cur[-1].N - 1).bit_length())) == Npad and \
                    bytes_needed <= max_group_bytes and \
                    _group_peak(cur + [st], size) <= budget:
                cur.append(st)
                continue
        groups.append([st])
    return groups, long_states


def sample_panels_batched(
    chrom_records: "dict[str, Sequence[UniqueKmersRecord]]",
    size: int,
    recombrate: float = 1.26,
    effective_N: float = 25000.0,
    add_reference: bool = False,
    path_outputs: "Optional[dict[str, str]]" = None,
    allele_penalty: int = 10,
    max_group_bytes: int = 2 << 30,
    device: "torch.device | str" = "cpu",
    budget: Optional[int] = None,
) -> "dict[str, List[List[int]]]":
    """Greedy panel reduction over several chromosomes, batched.

    Chromosomes of similar length (padded N within 2x, under
    ``max_group_bytes`` of [C, N, P] costs and within ``budget`` bytes,
    by default the device's free memory, :func:`plan_groups`) run
    together: each greedy iteration is ONE sweep and one chase over the
    group. Padding columns (emission cost 0 on every path, all paths
    live, switch cost 1) keep the real final column's first-minimum
    state, so paths are bit-identical to per-chromosome runs. A
    chromosome whose peak alone exceeds the budget runs on its own
    through the checkpointed scan (:func:`viterbi_iteration_segmented`,
    segments from :func:`segment_columns`), with the same paths.

    Updates every record's path set in place and returns
    {chromosome: sampled paths}.
    """
    from ..kmers.unique import bulk_update_paths

    path_outputs = path_outputs or {}
    out: "dict[str, List[List[int]]]" = {}

    states: List[_ChromState] = []
    for chromosome, records in chrom_records.items():
        if size < 1 or not len(records):
            out[chromosome] = []
            continue
        states.append(_ChromState(chromosome, records, recombrate, effective_N))

    states.sort(key=lambda s: s.N)
    if budget is None:
        budget = memory_budget(device)
    groups, long_states = plan_groups(states, size, max_group_bytes, budget)
    for group in groups:
        C = len(group)
        N_max = max(s.N for s in group)
        P = group[0].P
        A = max(s.costs.shape[1] for s in group)
        switch = np.ones((C, N_max), dtype=np.uint32)
        alleles = np.zeros((C, N_max, P), dtype=np.int32)
        valid = np.zeros((C, N_max), dtype=bool)
        costs0 = np.zeros((C, N_max, A), dtype=np.uint32)
        for c, st in enumerate(group):
            switch[c, : st.N] = st.switch
            st.fill_alleles(alleles[c, : st.N])
            valid[c, : st.N] = True
            costs0[c, : st.N, : st.costs.shape[1]] = st.costs
        all_paths = sample_group(
            torch.from_numpy(costs0.view(np.int32)).to(device),
            torch.from_numpy(alleles).to(device),
            torch.from_numpy(switch.view(np.int32)).to(device),
            torch.from_numpy(valid).to(device),
            size, int(allele_penalty),
        ).cpu().numpy()  # [size, C, N_max]
        for c, st in enumerate(group):
            for it in range(size):
                st.sampled_paths.append(all_paths[it, c, : st.N].tolist())
    for st in long_states:
        _sample_long(st, size, allele_penalty, budget, device)

    for st in [st for group in groups for st in group] + long_states:
        if add_reference:
            st.sampled_paths.append([0] * st.N)
        output = path_outputs.get(st.chromosome, "")
        if output:
            _write_paths(st.records, st.sampled_paths, output, st.chromosome)
        if st.sampled_paths:
            bulk_update_paths(
                st.records, np.asarray(st.sampled_paths, dtype=np.int64)
            )
        out[st.chromosome] = st.sampled_paths
    return out
