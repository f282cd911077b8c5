"""K-mer abundance histogram, smoothing, peak finding, coverage estimate.

(reference src/histogram.cpp:7-70 and src/sequenceutils.cpp:42-84)
"""

from __future__ import annotations

import sys
from typing import List, Tuple

import numpy as np


class Histogram:
    def __init__(self, max_value: int):
        self.histogram = np.zeros(max_value + 1, dtype=np.int64)

    @classmethod
    def from_file(cls, filename: str, max_value: int) -> "Histogram":
        """Load a ``count\\tvalue`` .histo file
        (reference src/histogram.cpp:12-24)."""
        h = cls(max_value)
        with open(filename) as f:
            for line in f:
                parts = line.split()
                if len(parts) < 2:
                    continue
                try:
                    count, value = int(parts[0]), int(parts[1])
                except ValueError:
                    continue
                if count <= max_value:
                    h.histogram[count] = value
        return h

    def add_value(self, value: int) -> None:
        if value < len(self.histogram):
            self.histogram[value] += 1

    def add_counts(self, counts: np.ndarray) -> None:
        """Bulk add (vectorized equivalent of repeated add_value)."""
        clipped = counts[counts < len(self.histogram)]
        self.histogram += np.bincount(
            clipped.astype(np.int64), minlength=len(self.histogram)
        )

    def write_to_file(self, filename: str) -> None:
        with open(filename, "w") as out:
            for i, v in enumerate(self.histogram):
                out.write(f"{i}\t{v}\n")

    def smooth_histogram(self) -> None:
        """Sequential in-place 3-point smoothing with INTEGER division.

        Must run sequentially: h[i] uses the already-smoothed h[i-1]
        (reference src/histogram.cpp:41-45).
        """
        h = self.histogram
        for i in range(1, len(h) - 1):
            h[i] = (h[i - 1] + h[i] + h[i + 1]) // 3

    def find_peaks(self) -> Tuple[List[int], List[int]]:
        """Local maxima: value positions where a strict descent follows a
        non-descent run. (reference src/histogram.cpp:47-63)
        """
        peak_ids: List[int] = []
        peak_values: List[int] = []
        direction = 0
        prev_val = 0
        for i, value in enumerate(self.histogram):
            if prev_val < value:
                direction = 0
            elif prev_val > value:
                if direction != 1:
                    peak_ids.append(i - 1)
                    peak_values.append(int(prev_val))
                direction = 1
            prev_val = value
        return peak_ids, peak_values


def compute_kmer_coverage_from_peaks(
    peak_ids: List[int], peak_values: List[int], largest_peak: bool
) -> int:
    """Pick the largest (or second-largest) histogram peak as coverage.

    (reference src/sequenceutils.cpp:42-84)
    """
    if len(peak_ids) == 0:
        raise RuntimeError("Histogram: no peak found in kmer-count histogram.")
    if len(peak_ids) < 2:
        print(
            f"Histogram peak: {peak_ids[0]} ({peak_values[0]})", file=sys.stderr
        )
        return peak_ids[0]
    if peak_values[0] < peak_values[1]:
        largest, largest_id = peak_values[1], peak_ids[1]
        second, second_id = peak_values[0], peak_ids[0]
    else:
        largest, largest_id = peak_values[0], peak_ids[0]
        second, second_id = peak_values[1], peak_ids[1]
    for value, idx in zip(peak_values, peak_ids):
        if value > largest:
            second, second_id = largest, largest_id
            largest, largest_id = value, idx
        elif value > second and value != largest:
            second, second_id = value, idx
    print(
        f"Histogram peaks: {largest_id} ({largest}), {second_id} ({second})",
        file=sys.stderr,
    )
    return largest_id if largest_peak else second_id
