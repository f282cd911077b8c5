"""Copy-number probability model: P(read count | CN in {0,1,2}).

(reference src/probabilitytable.cpp, src/copynumber.cpp)

CN0 ~ geometric(err(coverage)), CN1 ~ Poisson(coverage/2),
CN2 ~ Poisson(coverage); optional regularization constant c:
p_i' = (p_i + c) / (p0 + p1 + p2 + 3c), with p2' stored implicitly as
1 - p0' - p1' (reference src/copynumber.cpp:22-28 keeps only two probs).

The table over (coverage in [cov_min, cov_max), count in [0, count_max))
is kept both for parity with the reference's precompute/override hook
(``modify_probability`` is how the reference's HMM unit tests inject
arbitrary emission probabilities) and as the dense [count, cov, 3]
array shipped to the device for vectorized emission assembly.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np


def get_error_param(kmer_coverage: float) -> float:
    """CN0 geometric parameter, stepped by coverage.

    (reference src/probabilitytable.cpp:7-19)
    """
    if kmer_coverage < 10.0:
        return 0.99
    if kmer_coverage < 20:
        return 0.95
    if kmer_coverage < 40:
        return 0.9
    return 0.8


def poisson(mean: float, value: int) -> float:
    """exp(-mean + v*log(mean) - sum(log i)) (src/probabilitytable.cpp:75-81).

    Mirrors the reference's IEEE semantics at mean == 0 (cov_min can be 0
    when the abundance peak is < 4): C++ computes 0 * log(0) = NaN for
    value == 0 and exp(-inf) = 0 for value > 0 instead of raising.
    """
    log_sum = sum(math.log(i) for i in range(1, value + 1))
    with np.errstate(divide="ignore", invalid="ignore"):
        log_val = -mean + value * np.log(mean) - log_sum
        return float(np.exp(log_val))


def geometric(p: float, value: int) -> float:
    return (1.0 - p) ** value * p


class ProbabilityTable:
    """Precomputed CopyNumber probabilities with on-the-fly fallback."""

    def __init__(
        self,
        cov_min: int = 0,
        cov_max: int = 0,
        count_max: int = 0,
        regularization_const: float = 0.0,
    ):
        self.cov_min = cov_min
        self.cov_max = cov_max
        self.count_max = count_max
        self.regularization_const = regularization_const
        span = max(0, cov_max - cov_min)
        # table[count, cov - cov_min] = (p0, p1, p2)
        self.table = np.zeros((count_max, span, 3), dtype=np.float64)
        for count in range(count_max):
            for j in range(span):
                self.table[count, j] = self.compute_probability(cov_min + j, count)
        self._log_tables = {}

    def log_table(self, dtype=np.float64) -> np.ndarray:
        """log(table) cached per dtype (zero entries become -inf).

        Log magnitudes are small, so a float32 log table preserves the
        exact positivity structure of the float64 linear table — the
        densification gather (hmm/columns.py) reads this directly in
        the HMM's device dtype.
        """
        key = np.dtype(dtype)
        cached = getattr(self, "_log_tables", None)
        if cached is None:
            cached = self._log_tables = {}
        if key not in cached:
            with np.errstate(divide="ignore"):
                cached[key] = np.where(
                    self.table > 0, np.log(self.table), -np.inf
                ).astype(key)
        return cached[key]

    def compute_probability(
        self, kmer_coverage: int, read_kmer_count: int
    ) -> np.ndarray:
        p0 = geometric(get_error_param(kmer_coverage), read_kmer_count)
        p1 = poisson(kmer_coverage / 2.0, read_kmer_count)
        p2 = poisson(float(kmer_coverage), read_kmer_count)
        if self.regularization_const > 0:
            c = self.regularization_const
            total = p0 + p1 + p2 + 3.0 * c
            q0 = (p0 + c) / total
            q1 = (p1 + c) / total
            # reference stores only (q0, q1); CN2 is 1 - q0 - q1
            return np.array([q0, q1, 1.0 - q0 - q1], dtype=np.float64)
        return np.array([p0, p1, p2], dtype=np.float64)

    def get_probability(
        self, kmer_coverage: int, read_kmer_count: int
    ) -> np.ndarray:
        """(p_cn0, p_cn1, p_cn2) via table or fallback.

        (reference src/probabilitytable.cpp:47-53)
        """
        if (
            self.cov_min <= kmer_coverage < self.cov_max
            and read_kmer_count < self.count_max
        ):
            return self.table[read_kmer_count, kmer_coverage - self.cov_min]
        return self.compute_probability(kmer_coverage, read_kmer_count)

    def get_probabilities(
        self, kmer_coverage: int, read_kmer_counts: np.ndarray
    ) -> np.ndarray:
        """Vectorized (n, 3) probabilities for one coverage."""
        result = np.empty((len(read_kmer_counts), 3), dtype=np.float64)
        in_table = (
            self.cov_min <= kmer_coverage < self.cov_max
        ) * (read_kmer_counts < self.count_max)
        if np.any(in_table):
            result[in_table] = self.table[
                read_kmer_counts[in_table], kmer_coverage - self.cov_min
            ]
        for i in np.nonzero(~in_table)[0]:
            result[i] = self.compute_probability(
                kmer_coverage, int(read_kmer_counts[i])
            )
        return result

    def get_probabilities_rows(
        self, coverages: np.ndarray, read_kmer_counts: np.ndarray
    ) -> np.ndarray:
        """Vectorized (n, 3) probabilities with a PER-ROW coverage —
        one table gather for a whole block of variants (the per-record
        get_probabilities call was a genome-scale host cost)."""
        n = len(read_kmer_counts)
        result = np.empty((n, 3), dtype=np.float64)
        cov = np.asarray(coverages, dtype=np.int64)
        cnt = np.asarray(read_kmer_counts, dtype=np.int64)
        in_table = (
            (cov >= self.cov_min) & (cov < self.cov_max)
            & (cnt < self.count_max)
        )
        if self.table.size and np.any(in_table):
            result[in_table] = self.table[
                cnt[in_table], cov[in_table] - self.cov_min
            ]
        oob = np.nonzero(~in_table)[0]
        if len(oob):
            pairs = np.stack([cov[oob], cnt[oob]], axis=1)
            uniq, inverse = np.unique(pairs, axis=0, return_inverse=True)
            vals = np.stack(
                [self.compute_probability(int(c), int(x)) for c, x in uniq]
            )
            result[oob] = vals[inverse]
        return result

    def modify_probability(
        self, kmer_coverage: int, read_kmer_count: int, probs: Tuple[float, float, float]
    ) -> None:
        """Test hook: override a precomputed entry.

        (reference src/probabilitytable.cpp:67-73)
        """
        if (
            self.cov_min <= kmer_coverage < self.cov_max
            and read_kmer_count < self.count_max
        ):
            self.table[read_kmer_count, kmer_coverage - self.cov_min] = np.array(
                probs, dtype=np.float64
            )
            self._log_tables = {}
        else:
            raise RuntimeError(
                "ProbabilityTable.modify_probability: no precomputed values "
                "for these parameters."
            )
