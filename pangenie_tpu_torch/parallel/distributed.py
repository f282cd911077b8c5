"""Multi-process layer on ``torch.distributed``: one process a card.

Port of ``pangenie_tpu/parallel/distributed.py``. The reference runs one
JAX process a host, each driving its local chips; the port runs one
process (a rank) a card, as PyTorch runs several GPUs. Work placement
is the reference's:

  - read k-mer counting: every rank streams a disjoint shard of the
    reads (round-robin by sequence index). Against the same whole graph
    table on each card, the count vectors are then summed over the
    ranks (:func:`allreduce_sum`); with the table hash-partitioned over
    the ranks' cards, each read window travels to the rank that holds
    its key (``kmers/device_counter.py:ShardedPrimedDeviceCounter``).
  - HMM grid: the (chromosome x path-subset) work items are split
    round-robin over the ranks (:func:`partition`); each runs its items
    on its card, and the partial results are gathered to the
    coordinator (rank 0, :func:`gather_objects`), which merges them and
    writes the output files.

Configuration, read by :func:`maybe_initialize`: the reference's three
variables, PANGENIE_TPU_COORDINATOR=host:port (or any URL
``torch.distributed`` takes, such as ``file:///shared/path``),
PANGENIE_TPU_NUM_PROCESSES=N and PANGENIE_TPU_PROCESS_ID=i in each
process; or PANGENIE_TPU_DISTRIBUTED=auto under ``torchrun``, which sets
RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT. A process
that sets none of them makes no process group, and every helper here is
the identity.

The backend follows from the layout, read once at start-up: NCCL when
the ranks want cards and every host has a card for each of its ranks
(rank on a host i takes card i); gloo on the CPU
(PANGENIE_TORCH_DEVICE=cpu) or when ranks share a card. Under NCCL the
collectives run on tensors on the rank's card; under gloo on host
tensors, and the copies are made here. Nothing catches a failed
collective to try the other backend.
"""

from __future__ import annotations

import os
import pickle
import socket
from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch


class Layout(NamedTuple):
    """This rank's place: the backend, its rank among the ranks of its
    host, and its card (None on the CPU)."""

    backend: str
    local_rank: int
    card: Optional[int]


_layout: Optional[Layout] = None
_device_env: Optional[str] = None  # PANGENIE_TORCH_DEVICE before the rank set it


def _wants_cards() -> bool:
    name = os.environ.get("PANGENIE_TORCH_DEVICE") or "cuda"
    return torch.device(name).type == "cuda"


def choose_layout(rank: int, peers: Sequence[tuple]) -> Layout:
    """The layout of ``rank`` from every rank's (host name, visible
    cards): NCCL if every rank has cards and no host has more ranks than
    cards, else gloo; a rank's card is its index among its host's ranks,
    modulo the host's cards."""
    host, cards = peers[rank]
    same_host = [r for r, (h, _) in enumerate(peers) if h == host]
    local_rank = same_host.index(rank)
    per_host = {}
    for h, c in peers:
        per_host.setdefault(h, [0, c])[0] += 1
    nccl = all(c > 0 for _, c in peers) and all(n <= c for n, c in per_host.values())
    card = local_rank % cards if cards else None
    return Layout("nccl" if nccl else "gloo", local_rank, card)


def maybe_initialize() -> bool:
    """Join the process group the environment describes (idempotent).

    Runs before the first device use. Returns True when the run has more
    than one rank."""
    global _layout, _device_env
    if _layout is not None:
        return process_count() > 1
    coord = os.environ.get("PANGENIE_TPU_COORDINATOR")
    auto = os.environ.get("PANGENIE_TPU_DISTRIBUTED", "").lower() == "auto"
    if not coord and not auto:
        return False
    import torch.distributed as dist

    if coord:
        url = coord if "://" in coord else f"tcp://{coord}"
        rank = int(os.environ["PANGENIE_TPU_PROCESS_ID"])
        world = int(os.environ["PANGENIE_TPU_NUM_PROCESSES"])
    else:
        url, rank, world = "env://", int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    store, rank, world = next(dist.rendezvous(url, rank, world))
    cards = torch.cuda.device_count() if _wants_cards() and torch.cuda.is_available() else 0
    store.set(f"pangenie/layout/{rank}", f"{cards} {socket.gethostname()}")
    peers = []
    for r in range(world):
        c, h = store.get(f"pangenie/layout/{r}").decode().split(" ", 1)
        peers.append((h, int(c)))
    layout = choose_layout(rank, peers)
    if "LOCAL_RANK" in os.environ:  # torchrun's own count of a host's ranks
        local = int(os.environ["LOCAL_RANK"])
        layout = layout._replace(local_rank=local,
                                 card=None if layout.card is None else local % cards)
    if layout.card is not None:
        # the rank's card for device.resolve_device
        _device_env = os.environ.get("PANGENIE_TORCH_DEVICE")
        os.environ["PANGENIE_TORCH_DEVICE"] = f"cuda:{layout.card}"
        torch.cuda.set_device(layout.card)
    dist.init_process_group(layout.backend, store=store, rank=rank, world_size=world)
    _layout = layout
    return world > 1


def shutdown() -> None:
    """Leave the process group :func:`maybe_initialize` joined, if any,
    and give PANGENIE_TORCH_DEVICE back its value."""
    global _layout, _device_env
    if _layout is None:
        return
    import torch.distributed as dist

    dist.destroy_process_group()
    if _layout.card is not None:
        if _device_env is None:
            os.environ.pop("PANGENIE_TORCH_DEVICE", None)
        else:
            os.environ["PANGENIE_TORCH_DEVICE"] = _device_env
    _layout = _device_env = None


def layout() -> Optional[Layout]:
    """This rank's :class:`Layout`, or None without a process group."""
    return _layout


def process_count() -> int:
    if _layout is None:
        return 1
    import torch.distributed as dist

    return dist.get_world_size()


def process_index() -> int:
    if _layout is None:
        return 0
    import torch.distributed as dist

    return dist.get_rank()


def is_coordinator() -> bool:
    return process_index() == 0


def owns(index: int) -> bool:
    """Whether item ``index`` is this rank's (round-robin)."""
    return index % process_count() == process_index()


def partition(n_items: int) -> List[int]:
    """The item indices this rank owns (:func:`owns`). Deterministic and
    disjoint across ranks; the union over all ranks is range(n_items)."""
    return [i for i in range(n_items) if owns(i)]


# -- where collectives run ----------------------------------------------------


def comm_device() -> torch.device:
    """The device of the tensors a collective takes: the rank's card
    under NCCL, the host under gloo."""
    if _layout is not None and _layout.backend == "nccl":
        return torch.device("cuda", _layout.card)
    return torch.device("cpu")


def _to_comm(t: torch.Tensor) -> torch.Tensor:
    return t.to(comm_device()).contiguous()


# -- collectives over host data -----------------------------------------------

_CHUNK = 1 << 24  # elements an all-reduce chunk (bounds peak memory)


def allreduce_sum(x: np.ndarray) -> np.ndarray:
    """Element-wise sum of ``x`` across all ranks (host numpy in, host
    numpy out), in chunks of ``_CHUNK`` elements."""
    if _layout is None:
        return x
    import torch.distributed as dist

    x = np.asarray(x)
    flat = np.ascontiguousarray(x.reshape(-1))
    out = np.empty_like(flat)
    for start in range(0, len(flat), _CHUNK):
        chunk = _to_comm(torch.from_numpy(flat[start:start + _CHUNK].copy()))
        dist.all_reduce(chunk)
        out[start:start + _CHUNK] = chunk.cpu().numpy()
    return out.reshape(x.shape)


def gather_objects(obj: Any) -> Optional[List[Any]]:
    """Gather one picklable object a rank to the coordinator.

    Returns [obj_from_rank_0, ..., obj_from_rank_{n-1}] on the
    coordinator and None elsewhere: the pickles' lengths first, then the
    pickles padded to the longest, through all-gathers."""
    if _layout is None:
        return [obj]
    payload = np.frombuffer(pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL), dtype=np.uint8)
    parts = all_gather_varying(torch.from_numpy(payload.copy()))
    if not is_coordinator():
        return None
    return [pickle.loads(p.numpy().tobytes()) for p in parts]


def barrier() -> None:
    if _layout is None:
        return
    import torch.distributed as dist

    dist.barrier()


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


# -- collectives over device tensors ------------------------------------------


def all_reduce_sum_(t: torch.Tensor, group=None) -> torch.Tensor:
    """``t`` summed in place over the ranks of ``group`` (default: all)."""
    if _layout is None:
        return t
    import torch.distributed as dist

    c = _to_comm(t)
    dist.all_reduce(c, group=group)
    if c is not t:
        t.copy_(c)
    return t


def any_rank(flag: bool) -> bool:
    """Whether ``flag`` holds on some rank (a collective: every rank calls it)."""
    if _layout is None:
        return flag
    import torch.distributed as dist

    t = torch.tensor([int(flag)], dtype=torch.int64, device=comm_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def all_gather_varying(t: torch.Tensor) -> List[torch.Tensor]:
    """Every rank's 1-d ``t``, of any length, in rank order, on ``t``'s
    device: the lengths first, then the tensors padded to the longest."""
    if _layout is None:
        return [t]
    import torch.distributed as dist

    world = process_count()
    n = torch.tensor([t.shape[0]], dtype=torch.int64, device=comm_device())
    lengths = [torch.empty_like(n) for _ in range(world)]
    dist.all_gather(lengths, n)
    lengths = [int(x.item()) for x in lengths]
    padded = torch.zeros(max(lengths), dtype=t.dtype, device=comm_device())
    padded[:t.shape[0]] = t
    parts = [torch.empty_like(padded) for _ in range(world)]
    dist.all_gather(parts, padded)
    return [p[:m].to(t.device) for p, m in zip(parts, lengths)]


def gather_to_host(t: torch.Tensor) -> List[np.ndarray]:
    """Every rank's 1-d ``t``, of any length, in rank order, as host
    arrays on every rank. Each rank's tensor travels in broadcasts of
    ``_CHUNK`` elements through a buffer of that size, so a card holds
    one chunk beside its own ``t``, never the whole gather."""
    if _layout is None:
        return [t.cpu().numpy()]
    import torch.distributed as dist

    n = torch.tensor([t.shape[0]], dtype=torch.int64, device=comm_device())
    lengths = [torch.empty_like(n) for _ in range(process_count())]
    dist.all_gather(lengths, n)
    out = []
    for src, m in enumerate(int(x.item()) for x in lengths):
        host = torch.empty(m, dtype=t.dtype)
        for start in range(0, m, _CHUNK):
            size = min(_CHUNK, m - start)
            buf = (_to_comm(t[start:start + size]) if src == process_index()
                   else torch.empty(size, dtype=t.dtype, device=comm_device()))
            dist.broadcast(buf, src=src)
            host[start:start + size] = buf.cpu()
        out.append(host.numpy())
    return out


def all_to_all_exact(send: torch.Tensor, send_sizes: torch.Tensor) -> torch.Tensor:
    """Exchange a 1-d ``send`` whose first ``send_sizes[0]`` entries go to
    rank 0, the next ``send_sizes[1]`` to rank 1, and so on; returns what
    every rank sent here, in rank order, on ``send``'s device. The sizes
    travel first (one ``all_to_all_single``), so the exchange holds
    exactly the entries sent: nothing is padded and nothing can
    overflow."""
    if _layout is None:
        return send
    import torch.distributed as dist

    sizes = _to_comm(send_sizes.to(torch.int64))
    recv_sizes = torch.empty_like(sizes)
    dist.all_to_all_single(recv_sizes, sizes)
    s_list, r_list = sizes.tolist(), recv_sizes.tolist()
    out = torch.empty(sum(r_list), dtype=send.dtype, device=comm_device())
    dist.all_to_all_single(out, _to_comm(send), r_list, s_list)
    return out.to(send.device)


def all_to_all_bins(send: torch.Tensor, bin_sizes: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exchange a 1-d ``send`` of bins, ``bin_sizes`` [ranks, G] entries
    each in row-major order, bins (t, *) to rank t; returns what every
    rank sent here, in rank order, and the sizes of its bins [ranks, G]
    (row s: sender s's), both on ``send``'s device. Every bin's size
    travels first (one ``all_to_all_single`` of G sizes a rank), so the
    exchange holds exactly the entries sent and the receiver knows where
    each bin of each sender lies."""
    if _layout is None:
        return send, bin_sizes
    import torch.distributed as dist

    ranks, groups = bin_sizes.shape
    sizes = _to_comm(bin_sizes.reshape(-1).to(torch.int64))
    recv_sizes = torch.empty_like(sizes)
    dist.all_to_all_single(recv_sizes, sizes)
    recv_bins = recv_sizes.view(ranks, groups)
    s_list = sizes.view(ranks, groups).sum(1).tolist()
    r_list = recv_bins.sum(1).tolist()
    out = torch.empty(sum(r_list), dtype=send.dtype, device=comm_device())
    dist.all_to_all_single(out, _to_comm(send), r_list, s_list)
    return out.to(send.device), recv_bins.to(send.device)
