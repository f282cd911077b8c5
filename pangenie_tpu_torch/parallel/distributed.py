"""Single-process stand-in for the reference package's multi-host layer.

The reference's ``parallel/distributed.py`` spreads reads and HMM work
items over ``jax.distributed`` processes. The port runs in one process
until its multi-GPU layer (``torch.distributed``) lands; the host k-mer
counter only needs :func:`shard_sequences`.
"""

from __future__ import annotations

from typing import Optional, Sequence


def shard_sequences(seqs, shard: Optional[Sequence[int]]):
    """Yield every n-th sequence of an iterable: shard=(process index,
    process count). None = everything (single-process)."""
    if shard is None:
        yield from seqs
        return
    pid, n = shard
    for i, seq in enumerate(seqs):
        if i % n == pid:
            yield seq
