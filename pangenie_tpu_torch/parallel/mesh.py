"""Mesh construction over the ranks of the process group.

Port of ``pangenie_tpu/parallel/mesh.py``: a ``DeviceMesh`` of one rank
a card (``parallel/distributed.py``), its dims ``("subset", "batch")``.
"""

from __future__ import annotations

from typing import Optional, Tuple

from . import distributed


def _factor_2d(n: int) -> Tuple[int, int]:
    """Factor n into (subset, batch) with subset as small as possible
    while > 1 when n allows — subset-parallel traffic is a psum and
    benefits from staying on the shortest ICI ring."""
    if n <= 1:
        return (1, n)
    for s in (2, 3):
        if n % s == 0:
            return (s, n // s)
    return (1, n)


def make_mesh(shape: Optional[Tuple[int, int]] = None):
    """A (subset, batch) ``DeviceMesh`` over every rank, in rank order
    (rank r at row r // batch, column r % batch): ``shape`` (default
    :func:`_factor_2d` of the world size) must multiply to the world
    size. Needs the process group of
    :func:`distributed.maybe_initialize`, a world of one included."""
    from torch.distributed.device_mesh import init_device_mesh

    if distributed.layout() is None:
        raise RuntimeError("make_mesh: no process group; set the variables "
                           "distributed.maybe_initialize reads")
    world = distributed.process_count()
    shape = shape or _factor_2d(world)
    if shape[0] * shape[1] != world:
        raise RuntimeError(f"make_mesh: shape {shape} != the world's {world} ranks.")
    return init_device_mesh(distributed.comm_device().type, tuple(shape),
                            mesh_dim_names=("subset", "batch"))
