"""Path subsetting (the ``-a`` mechanism) — reference src/pathsampler.cpp.

Genotyping on huge panels is split across random subsets of paths whose
likelihoods are summed then normalized. The reference's subsets are
deterministic (default-seeded libstdc++ RNGs); we reproduce the exact
subsets via the bit-compatible RNG replicas in utils/rng.py so that
subset-split genotyping matches the reference run for run.
"""

from __future__ import annotations

from typing import List

from ..utils.rng import GlibcRand, MinstdRand0, random_shuffle, uniform_int

# std::rand()'s hidden global state: one stream per process, seed 1,
# shared by every random_shuffle call (reference never calls srand)
_GLOBAL_RAND = GlibcRand()


def reset_global_rand() -> None:
    """Reset the process-wide rand() replica (tests / fresh runs)."""
    global _GLOBAL_RAND
    _GLOBAL_RAND = GlibcRand()


class PathSampler:
    """Partition P paths into subsets (reference src/pathsampler.cpp)."""

    def __init__(self, total_number: int):
        self.total_number = total_number

    def select_single_subset(
        self, result: List[int], sample_size: int
    ) -> None:
        """Floyd's sampling with a fresh default-seeded engine.

        (src/pathsampler.cpp:14-28). Appends to ``result`` then sorts
        the WHOLE list — faithful to the reference, which sorts
        pre-existing entries too when topping up a short subset.
        """
        assert sample_size <= self.total_number
        sample = set()
        generator = MinstdRand0()
        for d in range(self.total_number - sample_size, self.total_number):
            t = uniform_int(generator, 0, d)
            if t not in sample:
                sample.add(t)
            else:
                sample.add(d)
        result.extend(sample)
        result.sort()

    def select_multiple_subsets(
        self, result: List[List[int]], sample_size: int, n: int
    ) -> None:
        for _ in range(n):
            sample: List[int] = []
            self.select_single_subset(sample, sample_size)
            result.append(sample)

    def partition_paths(
        self, result: List[List[int]], sample_size: int
    ) -> None:
        """Random partition of all paths (src/pathsampler.cpp:38-59)."""
        all_paths = list(range(self.total_number))
        random_shuffle(all_paths, _GLOBAL_RAND)
        for i in range(0, len(all_paths), sample_size):
            subset = sorted(all_paths[i : i + sample_size])
            result.append(subset)
        missing = sample_size - len(result[-1])
        if missing > 0:
            self.select_single_subset(result[-1], missing)

    def partition_samples(
        self, result: List[List[int]], sample_size: int
    ) -> None:
        """Partition keeping diploid pairs together; ref path (odd P)
        goes to the first subset (src/pathsampler.cpp:61-103).
        """
        assert self.total_number > 0
        n = self.total_number - 1
        reference_added = self.total_number % 2 != 0

        all_samples = []
        if reference_added:
            # reference path not part of the panel
            for i in range(1, n, 2):
                all_samples.append((i, i + 1))
        else:
            for i in range(0, n, 2):
                all_samples.append((i, i + 1))

        random_shuffle(all_samples, _GLOBAL_RAND)

        all_paths: List[int] = []
        if reference_added:
            all_paths.append(0)
        for a, b in all_samples:
            all_paths.append(a)
            all_paths.append(b)

        for i in range(0, len(all_paths), sample_size):
            subset = sorted(all_paths[i : i + sample_size])
            result.append(subset)
        missing = sample_size - len(result[-1])
        if missing > 0:
            self.select_single_subset(result[-1], missing)
