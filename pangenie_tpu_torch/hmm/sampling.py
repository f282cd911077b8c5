"""Haplotype sampling (panel reduction, the ``-x`` mechanism) in torch.

Port of ``pangenie_tpu/hmm/sampling.py:sample_panels_batched``
(reference src/haplotypesampler.cpp:20-314). Each of the ``size``
greedy iterations runs one masked single-path min-plus Viterbi per
chromosome — kernel S1 (``csrc/sampling_dp.cu``) on the card, the
plain column loop :func:`viterbi_iteration_plain` on the CPU — then
masks the chosen paths and penalizes their alleles with elementwise
torch (``min(cost + penalty, 25)``, padding columns left alone).

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
from typing import List, Optional, Sequence

import numpy as np
import torch

from .._build import CudaKernel, launch_stream
from ..kmers.unique import UniqueKmersRecord

UINT_MAX = 0xFFFFFFFF

_P = ctypes.c_void_p
_I = ctypes.c_int
# kernel S1: replaces pangenie_tpu/hmm/sampling.py:_viterbi_iteration
# (and its blocked form _blocked_viterbi)
S1 = CudaKernel(
    "sampling_dp", "pg_viterbi_iteration", "s1", [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P]
)
# one thread per path in a CTA
MAX_PATHS = 1024


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


def viterbi_iteration_plain(path_cost, mask, switch):
    """Plain version of kernel S1, batched over C chromosomes.

    Args:
      path_cost: [C, N, P] int32 tensor holding uint32 emission costs.
      mask: [C, N, P] bool, True where the path is still available.
      switch: [C, N] int32 holding uint32 switch costs (entry 0 unused).

    Returns (paths [C, N] int32, best_scores [C] int64 uint32 values).
    """
    C, N, P = path_cost.shape
    dev = path_cost.device
    cost = path_cost.to(torch.int64) & UINT_MAX
    sw = switch.to(torch.int64) & UINT_MAX
    idx = torch.arange(P, device=dev)
    umax = torch.full((C, P), UINT_MAX, dtype=torch.int64, device=dev)
    prev = torch.zeros((C, P), dtype=torch.int64, device=dev)
    prev_mask = torch.zeros((C, P), dtype=torch.bool, device=dev)
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
        if n == 0:
            prev_cell = torch.zeros_like(prev_cell)
            back = torch.zeros_like(back)
        m = mask[:, n]
        prev = torch.where(m, _sat_add(prev_cell, cost[:, n]), umax)
        prev_mask = m
        bts[:, n] = back.to(torch.int32)
    best_score, state = _first_min(prev, idx)
    paths = torch.empty((C, N), dtype=torch.int32, device=dev)
    for n in range(N - 1, -1, -1):
        paths[:, n] = state
        state = bts[:, n].gather(1, state[:, None].to(torch.int64))[:, 0].to(torch.int64)
    return paths, best_score


def viterbi_iteration(path_cost, mask, switch):
    """One masked min-plus Viterbi per chromosome — kernel S1 on CUDA
    tensors, :func:`viterbi_iteration_plain` on CPU tensors."""
    if path_cost.device.type == "cpu":
        return viterbi_iteration_plain(path_cost, mask, switch)
    C, N, P = path_cost.shape
    dev = path_cost.device
    if P > MAX_PATHS:
        raise ValueError(f"{P} paths exceed kernel S1's limit of {MAX_PATHS}")
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
    bt = torch.empty((C, N, P), dtype=torch.int32, device=dev)
    paths = torch.empty((C, N), dtype=torch.int32, device=dev)
    best = torch.empty((C,), dtype=torch.int32, device=dev)
    if C and N:
        S1(path_cost.data_ptr(), mask.data_ptr(), switch.data_ptr(), bt.data_ptr(),
           paths.data_ptr(), best.data_ptr(), C, N, P, launch_stream(dev))
    return paths, best.to(torch.int64) & UINT_MAX


def sample_group(costs, alleles, switch, valid, size: int, allele_penalty: int,
                 viterbi=viterbi_iteration):
    """Batched greedy sampling over a [C, N] group of chromosomes.

    Port of the reference package's ``_sample_group``.

    Args:
      costs: [C, N, A] int32 initial per-allele emission costs.
      alleles: [C, N, P] int64 path->allele.
      switch: [C, N] int32 per-column switch costs (1 in padding).
      valid: [C, N] bool — False on padding columns (their mask and
        penalty updates are suppressed so they stay neutral).
      viterbi: the per-iteration DP; chip_smoke.py passes the plain
        version to hold kernel S1 against it on the card.

    Returns [size, C, N] int32 sampled path per iteration.
    """
    C, N, P = alleles.shape
    p_iota = torch.arange(P, device=alleles.device)
    penalty = int(allele_penalty) & UINT_MAX
    path_cost = torch.gather(costs, 2, alleles).contiguous()
    used = torch.zeros((C, N, P), dtype=torch.bool, device=alleles.device)
    valid3 = valid[:, :, None]
    out = []
    for _ in range(size):
        paths, _scores = viterbi(path_cost, ~used, switch)
        paths = paths.to(torch.int64)
        used |= (p_iota == paths[:, :, None]) & valid3
        # penalize the chosen allele on every path carrying it (uint32
        # arithmetic, as the reference package's broadcast update)
        chosen = torch.gather(alleles, 2, paths[:, :, None])
        sel = (alleles == chosen) & valid3
        pen = torch.clamp_max(((path_cost.to(torch.int64) & UINT_MAX) + penalty) & UINT_MAX, 25)
        path_cost = torch.where(sel, pen.to(torch.int32), path_cost)
        out.append(paths.to(torch.int32))
    return torch.stack(out)


class _ChromState:
    """Dense per-chromosome sampling state for the batched driver."""

    def __init__(self, chromosome: str, records: Sequence[UniqueKmersRecord],
                 recombrate: float, effective_N: float):
        self.chromosome = chromosome
        self.records = records
        self.N = len(records)
        self.P = records[0].get_nr_paths()
        self.costs = bulk_emission_costs(records)  # [N, A]
        alleles = np.empty((self.N, self.P), dtype=np.int32)
        for n, r in enumerate(records):
            alleles[n] = r.path_to_allele
        self.alleles = alleles
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
) -> "dict[str, List[List[int]]]":
    """Greedy panel reduction over several chromosomes, batched.

    Chromosomes of similar length (padded N within 2x, under
    ``max_group_bytes`` of [C, N, P] costs) run together: each greedy
    iteration is ONE kernel launch over the group. Padding columns
    (emission cost 0 on every path, all paths live, switch cost 1)
    keep the real final column's first-minimum state, so paths are
    bit-identical to per-chromosome runs.

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

    # the reference package streams chromosomes whose [N, P] backtraces
    # exceed 1 GiB through a checkpointed scan; the port does not yet
    full_budget = 1 << 30
    for s in states:
        if s.N * s.P * 4 > full_budget:
            raise NotImplementedError(
                f"sampling {s.chromosome}: {s.N} columns x {s.P} paths need "
                "the segmented sampling DP (ROADMAP queue 1, segmented scans)"
            )

    # group chromosomes of similar length (padded N within 2x) under a
    # device-memory cap
    states.sort(key=lambda s: s.N)
    groups: List[List[_ChromState]] = []
    for st in states:
        Npad = 1 << max(0, (st.N - 1).bit_length())
        if groups:
            cur = groups[-1]
            cur_pad = 1 << max(0, (cur[0].N - 1).bit_length())
            pad_target = max(cur_pad, Npad)
            bytes_needed = (
                (len(cur) + 1) * pad_target * st.P * 4
            )
            if (1 << max(0, (cur[-1].N - 1).bit_length())) == Npad and \
                    bytes_needed <= max_group_bytes:
                cur.append(st)
                continue
        groups.append([st])

    for group in groups:
        C = len(group)
        N_max = max(s.N for s in group)
        P = group[0].P
        A = max(s.costs.shape[1] for s in group)
        switch = np.ones((C, N_max), dtype=np.uint32)
        alleles = np.zeros((C, N_max, P), dtype=np.int64)
        valid = np.zeros((C, N_max), dtype=bool)
        costs0 = np.zeros((C, N_max, A), dtype=np.uint32)
        for c, st in enumerate(group):
            switch[c, : st.N] = st.switch
            alleles[c, : st.N] = st.alleles
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

    for st in states:
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
