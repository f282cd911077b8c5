"""Bit-compatible replicas of the RNGs the reference relies on.

The reference's path subsetting is "deterministic by accident": it uses
default-seeded libstdc++ RNGs (`std::default_random_engine` in
src/pathsampler.cpp:17, `std::random_shuffle`/glibc `rand()` in
src/pathsampler.cpp:43,78) and never seeds them. Partitioning therefore
always produces the same subsets for a given panel size. To genotype
identically we replicate those exact bit streams:

- :class:`MinstdRand0` — libstdc++ ``default_random_engine``
  (minstd_rand0: x' = 16807 x mod 2147483647, default seed 1).
- :func:`uniform_int` — libstdc++ ``uniform_int_distribution``
  downscaling-with-rejection algorithm (bits/uniform_int_dist.h).
- :class:`GlibcRand` — glibc ``rand()`` (TYPE_3 additive feedback,
  default seed 1), consumed by libstdc++ ``std::random_shuffle``.
- :func:`random_shuffle` — libstdc++ ``std::random_shuffle(first,last)``
  (Fisher-Yates using ``std::rand() % (i+1)``).
"""

from __future__ import annotations

from typing import MutableSequence


class MinstdRand0:
    """libstdc++ minstd_rand0: x' = 16807 * x mod (2^31 - 1), seed 1."""

    MIN = 1
    MAX = 2147483646

    def __init__(self, seed: int = 1):
        seed = seed % 2147483647
        if seed == 0:
            seed = 1
        self.state = seed

    def __call__(self) -> int:
        self.state = (16807 * self.state) % 2147483647
        return self.state


def uniform_int(gen: MinstdRand0, a: int, b: int) -> int:
    """libstdc++ uniform_int_distribution(a, b)(gen).

    Replicates the downscaling-with-rejection path used when the
    generator range exceeds the target range (always true here:
    minstd range is 2^31 - 2).
    """
    urange = b - a + 1
    grange = gen.MAX - gen.MIN + 1  # 2147483646
    if urange == grange:
        return gen() - gen.MIN + a
    if urange > grange:
        raise NotImplementedError("upscaling path not used by the reference")
    scaling = grange // urange
    past = urange * scaling
    while True:
        ret = gen() - gen.MIN
        if ret < past:
            break
    return ret // scaling + a


class GlibcRand:
    """glibc rand(): TR1 additive feedback generator (TYPE_3), seed 1.

    State r has 34 entries; r[i] = r[i-3] + r[i-31] mod 2^32 with the
    first 310 outputs discarded; each output is r[i] >> 1.
    """

    def __init__(self, seed: int = 1):
        r = [0] * 344
        r[0] = seed % (1 << 32)
        for i in range(1, 31):
            # r[i] = (16807 * r[i-1]) % 2147483647, computed the glibc way
            hi, lo = divmod(r[i - 1], 127773)
            word = 16807 * lo - 2836 * hi
            if word < 0:
                word += 2147483647
            r[i] = word
        for i in range(31, 34):
            r[i] = r[i - 31]
        for i in range(34, 344):
            r[i] = (r[i - 3] + r[i - 31]) % (1 << 32)
        self._r = r[-34:]
        # indexes into the rolling 34-entry window
        self._idx3 = 31  # i - 3
        self._idx31 = 3  # i - 31

    def __call__(self) -> int:
        r = self._r
        value = (r[self._idx3] + r[self._idx31]) % (1 << 32)
        # rotate window
        r.pop(0)
        r.append(value)
        return value >> 1


def random_shuffle(seq: MutableSequence, rand: GlibcRand) -> None:
    """libstdc++ std::random_shuffle(first, last) in place.

    for i in 1..n-1: swap(seq[i], seq[rand() % (i + 1)])
    """
    for i in range(1, len(seq)):
        j = rand() % (i + 1)
        seq[i], seq[j] = seq[j], seq[i]
