"""Meshes of ranks and sharded execution.

The reference is a single-process multi-threaded program (ThreadPool,
src/threadpool.cpp) whose parallel axes are chromosomes and path
subsets (src/commands.cpp:955-978). Here those axes become a mesh of
ranks, one a card (``torch.distributed``):

- ``batch``  — data parallelism over (chromosome-block) work items,
- ``subset`` — parallelism over path subsets whose raw likelihoods are
  combined with an all-reduce (the reference's mutex-guarded likelihood
  merge, src/commands.cpp:163-184, becomes a collective).
"""

from .mesh import make_mesh
from .genotyping import sharded_forward_backward

__all__ = ["make_mesh", "sharded_forward_backward"]
