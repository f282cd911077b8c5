"""PairHMM: genotyping and phasing per (chromosome, path subset), in
torch.

Port of ``pangenie_tpu/hmm/genotyping.py``: genotyping
(forward-backward) and phasing (Viterbi, ``viterbi.py``) with deferred,
batched execution. Inputs are
densified on the host (``columns.py``), padded to power-of-two buckets,
moved to the device as torch tensors, run through
:func:`batch.forward_backward_batch` and scattered back into
GenotypeLikelihoods on the host. The un-rescale of the device
posteriors stays in numpy ``longdouble``: raw likelihoods can lie far
below float64 range (e.g. 1e-400), and the reference's cross-subset
combine adds them raw.

A run over ``fb_generic.SEGMENT`` columns (a long chromosome) is not
padded to a bucket and executes alone, with B=1: the dispatcher sends it
down the chunked generic route (kernels K3/K4 with carries), whose
device memory is O(chunk * P^2) — the counterpart of the reference's
``forward_backward_segmented`` streaming — and phases through
``viterbi.viterbi_segmented`` over its columns padded to a bucket as the
reference pads them (the padding columns lie on the chased path).

Phasing runs of one padded shape run as one batch of kernel V1 (the
reference vmaps them); the Viterbi backtrack stores the haplotype
alleles at the record each column maps to, and (as src/hmm.cpp:164-165
does) the k-mer count and coverage at the COLUMN index.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..kmers.unique import UniqueKmersRecord
from ..model.probabilities import ProbabilityTable
from ..panel.variant import GenotypeLikelihoods
from . import fb_generic
from .batch import forward_backward_batch
from .columns import HMMColumns, build_columns, transition_probs
from .emissions import emission_scale
from .forward_backward import ColumnArrays
from .viterbi import viterbi, viterbi_segmented


# numpy dtype of the host-side grids for each HMM device dtype
NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}


def _bucket(n: int, minimum: int = 16) -> int:
    """Round up to the next power of two (shape bucketing, so runs of
    similar size batch together)."""
    b = minimum
    while b < n:
        b *= 2
    return b


def _to_device_columns(
    columns: HMMColumns,
    recombrate: float,
    effective_N: float,
    uniform: bool,
    dtype: torch.dtype,
    device: torch.device,
    pad_columns: bool = True,
) -> ColumnArrays:
    N = columns.n_columns
    trans = np.ones((N, 3), dtype=np.float64)
    if N >= 2:
        trans[1:] = transition_probs(
            columns.positions, columns.n_paths, recombrate, effective_N, uniform
        )

    lp = columns.log_probs
    incidence = columns.incidence
    kmer_mask = columns.kmer_mask
    alleles = columns.alleles
    undefined = columns.undefined
    all_zeros = columns.all_zeros
    allele_local = columns.allele_local
    nr_local = columns.nr_local

    # pad columns (N), kmers (K) and alleles (A) up to power-of-two
    # buckets. Padding is EXACT, not approximate:
    # - extra kmer slots are masked out (contribute nothing),
    # - extra allele slots have empty incidence and are never
    #   referenced by allele_local,
    # - extra COLUMNS get all_zeros=True (emission == 1 uniformly)
    #   and stay-only transitions t=(1,0,0): the forward alpha and
    #   backward beta pass through them unchanged, the per-column
    #   normalization constants are 1, and their posteriors are
    #   simply ignored by the scatter. This reproduces the exact
    #   unpadded recurrence values at every real column.
    K = lp.shape[1]
    A = incidence.shape[2]
    P = alleles.shape[1]
    Np, Kp, Ap = _bucket(N, 16), _bucket(K, 8), _bucket(A, 2)
    if not pad_columns:
        Np = N

    def pad(arr, shape, fill=0):
        out = np.full(shape, fill, dtype=arr.dtype)
        out[tuple(slice(0, s) for s in arr.shape)] = arr
        return out

    if Kp != K or Ap != A or Np != N:
        lp = pad(lp, (Np, Kp, 3))
        incidence = pad(incidence, (Np, Kp, Ap))
        kmer_mask = pad(kmer_mask, (Np, Kp))
        alleles = pad(alleles, (Np, P))
        undefined = pad(undefined, (Np, Ap))
        all_zeros = pad(all_zeros, (Np,), fill=False)
        all_zeros[N:] = True
        allele_local = pad(allele_local, (Np, P))
        nr_local = pad(nr_local, (Np,))
        trans_p = np.zeros((Np, 3), dtype=np.float64)
        trans_p[:N] = trans
        trans_p[N:, 0] = 1.0  # stay-only through padding columns
        trans = trans_p

    is_last = np.zeros(len(all_zeros), dtype=bool)
    if N > 0:
        is_last[N - 1] = True

    def dev(x, dt=None):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device=device, dtype=dt)

    lp_t = dev(lp, dtype)
    kmer_mask_t = dev(kmer_mask)
    return ColumnArrays(
        lp=lp_t,
        incidence=dev(incidence),
        kmer_mask=kmer_mask_t,
        alleles=dev(alleles.astype(np.int64)),
        undefined=dev(undefined),
        all_zeros=dev(all_zeros),
        scale=emission_scale(lp_t, kmer_mask_t),
        trans=dev(trans, dtype),
        allele_local=dev(allele_local.astype(np.int64)),
        nr_local=dev(nr_local.astype(np.int64)),
        is_last=dev(is_last),
    )


class PairHMM:
    """Forward-backward (genotyping) and Viterbi (phasing) over path-pair
    states.

    With ``defer=True`` the constructor only densifies inputs; call
    :func:`run_deferred` on a list of deferred instances to execute
    them batched — instances whose padded shapes match run as ONE batch
    (chromosomes and path subsets become the batch dim). ``prebuilt``
    (another run's :meth:`shared_columns`) reuses the columns of a run
    over the same records and path subset.
    """

    def __init__(
        self,
        records: Sequence[UniqueKmersRecord],
        probabilities: ProbabilityTable,
        run_genotyping: bool,
        run_phasing: bool,
        recombrate: float = 1.26,
        uniform: bool = False,
        effective_N: float = 25000.0,
        only_paths: Optional[Sequence[int]] = None,
        normalize: bool = True,
        dtype: torch.dtype = torch.float64,
        defer: bool = False,
        dense=None,
        prebuilt=None,
        bulk: bool = False,
        device: "torch.device | str" = "cpu",
    ):
        _t0 = time.monotonic()
        self.runtime = 0.0  # host build seconds
        self.records = records
        self._run_genotyping = run_genotyping
        self._run_phasing = run_phasing
        self._uniform = uniform
        self._normalize = normalize
        self.genotyping_result: List[GenotypeLikelihoods] = [
            GenotypeLikelihoods() for _ in records
        ]
        # (mask[M], vals[M, 3]) array-resident likelihood channel for
        # canonical biallelic variants, filled by _scatter_genotypes on
        # normalized runs when opted in (the command driver does; direct
        # users keep the reference's dict-per-variant contract)
        self.bulk_likelihoods = None
        self._bulk_enabled = bulk
        self.columns = None
        self.device_cols = None
        if records and prebuilt is not None:
            # genotyping and phasing over the same subset share columns
            self.columns, self.device_cols = prebuilt
        elif records:
            self.columns = build_columns(
                records, probabilities, only_paths, dense=dense,
                dtype=NP_DTYPE[dtype],
            )
            if self.columns.n_columns > 0:
                self.device_cols = _to_device_columns(
                    self.columns, recombrate, effective_N, uniform, dtype,
                    torch.device(device), pad_columns=not self.is_long(),
                )
        self.runtime += time.monotonic() - _t0
        if not defer:
            PairHMM.run_deferred([self])

    def shared_columns(self):
        """(columns, device_cols) for PairHMM(prebuilt=...)."""
        return (self.columns, self.device_cols)

    def is_long(self) -> bool:
        """More columns than ``fb_generic.SEGMENT``: runs alone, chunked."""
        return (self.columns is not None
                and self.columns.n_columns > fb_generic.SEGMENT)

    def _store_kmer_stats(self) -> None:
        for i, record in enumerate(self.records):
            self.genotyping_result[i].nr_unique_kmers = record.size()
            self.genotyping_result[i].coverage = record.get_coverage()

    def _finish_genotyping(
        self, posteriors: np.ndarray, log_corr: np.ndarray
    ) -> None:
        self._scatter_genotypes(
            posteriors, log_corr, normalized=self._normalize
        )
        self._store_kmer_stats()

    # -- host scatter ------------------------------------------------------

    def _scatter_genotypes(
        self, posteriors: np.ndarray, log_corr: np.ndarray,
        normalized: bool = False,
    ) -> None:
        columns = self.columns
        N = columns.n_columns
        if N == 0:
            return
        # undo the device-side emission rescale in extended precision so
        # stored raw likelihoods match the reference's long double scale
        # (they can be far below f64 range, e.g. 1e-400)
        corr = np.exp(log_corr.astype(np.longdouble))
        A = columns.local_alleles.shape[1]
        G = posteriors[:, :A, :A].astype(np.longdouble) * corr[:, None, None]
        # symmetrize: value of unordered pair (i<j) is G[i,j] + G[j,i]
        sym = G + np.swapaxes(G, 1, 2)
        iu, ju = np.triu_indices(A)
        vals = sym[:, iu, ju]                     # [N, A*(A+1)/2]
        diag_cols = np.nonzero(iu == ju)[0]
        vals[:, diag_cols] = G[:, iu[diag_cols], ju[diag_cols]]
        vals = vals[:N]  # drop bucket-padding columns
        if normalized:
            # vectorized GenotypeLikelihoods.normalize over all columns
            # (same math: dominant entry via the reciprocal form so the
            # long-double rounding of near-certain probabilities matches
            # the per-object path at the final ulp). Only pairs with
            # j < nr_local exist; higher pair slots carry zeros and do
            # not perturb totals.
            valid = ju[None, :] < columns.nr_local[:, None]
            vals = np.where(valid, vals, np.longdouble(0.0))
            total = vals.sum(axis=1)
            vmax = vals.max(axis=1)
            pos = total > 0
            with np.errstate(divide="ignore", invalid="ignore"):
                scaled = vals / total[:, None]
                rest = (total - vmax) / vmax
                dom = np.longdouble(1.0) / (np.longdouble(1.0) + rest)
            is_dom = (vals == vmax[:, None]) & (vals > 0)
            out = np.where(is_dom, dom[:, None], scaled)
            vals = np.where(pos[:, None], out, vals)
        la = columns.local_alleles
        nr_local = columns.nr_local
        variant_ids_a = columns.variant_ids[:N]
        # ARRAY-RESIDENT fast channel: canonical biallelic columns
        # (local alleles exactly [0, 1]) keep their normalized
        # {(0,0),(0,1),(1,1)} likelihoods in one [M, 3] longdouble array
        # instead of per-variant dicts; the VCF writers read it directly
        # and only slow-path rows ever materialize a dict. Only active
        # for the single-subset normalized run (cross-subset combine
        # still sums dicts).
        if normalized and self._bulk_enabled:
            elig = (
                (nr_local[:N] == 2) & (la[:N, 0] == 0) & (la[:N, 1] == 1)
            )
            elig_rows = np.nonzero(elig)[0]
            if elig_rows.size:
                M = len(self.genotyping_result)
                mask = np.zeros(M, dtype=bool)
                v3 = np.zeros((M, 3), dtype=np.longdouble)
                vids = variant_ids_a[elig_rows]
                mask[vids] = True
                # pair columns of (0,0), (0,1), (1,1) in triu order
                v3[vids] = vals[elig_rows][:, [0, 1, A]]
                self.bulk_likelihoods = (mask, v3)
            dict_rows = np.nonzero(~elig)[0]
        else:
            dict_rows = np.arange(N)
        if dict_rows.size == 0:
            return
        key_a = la[dict_rows][:, iu].tolist()  # [rows][pairs]
        key_b = la[dict_rows][:, ju].tolist()
        dvals = vals[dict_rows]
        # a pair (i <= j) exists iff j < nr_local; precompute the valid
        # pair-column lists per nr_local value (avoids per-row nonzero)
        d_nr_local = nr_local[dict_rows]
        pair_cols = {
            c: np.nonzero(ju < c)[0].tolist()
            for c in np.unique(d_nr_local).tolist()
        }
        nr_local_list = d_nr_local.tolist()
        variant_ids = variant_ids_a[dict_rows].tolist()
        results = self.genotyping_result
        # zero-valued entries still create map keys, as the reference's
        # operator[] does — the uniqueness check and
        # contains_no_likelihoods() observe them
        for n in range(dict_rows.size):
            ka, kb, vn = key_a[n], key_b[n], dvals[n]
            results[variant_ids[n]].likelihoods = {
                (ka[c], kb[c]): vn[c] for c in pair_cols[nr_local_list[n]]
            }

    def _phase(self, stacked: ColumnArrays, run: Sequence["PairHMM"]) -> None:
        """Viterbi over the stacked columns of ``run`` (one batch of V1
        on a card), scattered into each run's haplotypes. A long run's
        columns are padded to the bucket the reference pads them to and
        walked by the checkpointed scan: in ``fb_generic.SEGMENT``
        columns on the CPU, in the longest segments the free memory
        holds on a card."""
        if self.is_long():
            segment = fb_generic.SEGMENT if stacked.lp.device.type == "cpu" else None
            states = viterbi_segmented(stacked, segment, self._uniform,
                                       length=_bucket(self.columns.n_columns))
        else:
            states = viterbi(stacked, self._uniform)
        states = states.cpu().numpy()
        for i, hmm in enumerate(run):
            hmm._scatter_haplotypes(states[i])

    def _scatter_haplotypes(self, states: np.ndarray) -> None:
        columns = self.columns
        N = columns.n_columns
        if N == 0:
            return
        P = columns.n_paths
        # bulk index math on arrays; the remaining loop only assigns
        # plain ints to result objects (no per-column numpy scalars)
        states = np.asarray(states[:N], dtype=np.int64)
        rows = np.arange(N)
        allele1 = columns.alleles[rows, states // P].tolist()
        allele2 = columns.alleles[rows, states % P].tolist()
        variant_ids = columns.variant_ids.tolist()
        results = self.genotyping_result
        for n in range(N):
            g = results[variant_ids[n]]
            g.haplotype_1 = allele1[n]
            g.haplotype_2 = allele2[n]
        # reference quirk: kmer count / coverage written at the
        # COLUMN index, not the variant id (src/hmm.cpp:164-165)
        for n in range(N):
            g = results[n]
            record = self.records[n]
            g.nr_unique_kmers = record.size()
            g.coverage = record.get_coverage()

    # -- reference-parity accessors ----------------------------------------

    def get_genotyping_result(self) -> List[GenotypeLikelihoods]:
        return self.genotyping_result

    def move_genotyping_result(self) -> List[GenotypeLikelihoods]:
        result = self.genotyping_result
        self.genotyping_result = []
        return result

    def move_bulk_likelihoods(self):
        """(mask, vals) array-resident biallelic likelihoods, or None."""
        bulk = self.bulk_likelihoods
        self.bulk_likelihoods = None
        return bulk

    @staticmethod
    def run_deferred(hmms: Sequence["PairHMM"]) -> None:
        """Execute deferred PairHMMs, batching shape-compatible runs.

        Runs whose padded tensors have identical shapes (same bucket:
        chromosomes of similar size, path subsets of the same panel)
        execute as ONE batched forward-backward, and phasing runs as ONE
        batched Viterbi — the (chromosome x subset) grid becomes the
        batch dimension, as in the reference's thread pool over the same
        grid (src/commands.cpp:955-978). A long run (over
        ``fb_generic.SEGMENT`` columns) executes alone, as the
        reference's streaming path does.
        """
        groups = {}
        for hmm in hmms:
            if hmm.device_cols is None:
                if hmm._run_genotyping:
                    hmm._store_kmer_stats()
                continue
            key = (id(hmm),) if hmm.is_long() else tuple(
                x.shape for x in hmm.device_cols)
            groups.setdefault((key, hmm._run_genotyping, hmm._run_phasing,
                               hmm._uniform), []).append(hmm)

        for (_key, run_g, run_p, _uniform), members in groups.items():
            if not (run_g or run_p):
                continue
            stacked = ColumnArrays(
                *[torch.stack(xs) for xs in zip(*[h.device_cols for h in members])]
            )
            if run_g:
                posteriors, log_corr = forward_backward_batch(stacked)
                posteriors = posteriors.cpu().numpy()
                log_corr = log_corr.cpu().numpy()
                for i, hmm in enumerate(members):
                    hmm._finish_genotyping(posteriors[i], log_corr[i])
            if run_p:
                members[0]._phase(stacked, members)

    def combine_likelihoods(self, other: "PairHMM") -> None:
        if len(self.genotyping_result) != len(other.genotyping_result):
            raise RuntimeError(
                "PairHMM.combine_likelihoods: HMMs must be the same size."
            )
        for mine, theirs in zip(self.genotyping_result, other.genotyping_result):
            mine.combine(theirs)

    def normalize(self) -> None:
        for g in self.genotyping_result:
            g.normalize()
