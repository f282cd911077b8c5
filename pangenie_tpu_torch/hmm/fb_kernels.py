"""Wrappers of the forward-backward kernels in ``csrc/fb.cu``: K1
(forward) and K2 (backward) on [A, A] emissions, K3 (forward) and K4
(backward) on precomputed [P, P] state emissions.

K1 and K2 run one warp a chain up to 32 paths and 8 alleles, else a CTA
of 256 threads a chain (:func:`fused_threads`, one rule for both).

On CPU tensors each wrapper runs its plain torch version
(``forward_plain`` / ``backward_plain`` in ``forward_backward.py``,
``forward_e_plain`` / ``backward_e_plain`` in ``fb_generic.py``); on
CUDA tensors it launches the kernel or raises — there is no fallback
from the card to the plain version. The wrappers check device, dtype,
shape and contiguity and allocate the outputs and the grid tier's
scratch; the kernels allocate nothing.

K1/K2 take at most ``MAX_PATHS`` paths; ``batch.use_generic`` sends
every batch with more to K3/K4: up to ``MAX_PATHS`` with the [P, P]
state in one CTA's registers, then in the registers of a thread-block
cluster of CTAs a chain (``cluster_layout``, up to 471 paths), beyond it
on the grid tier (``grid_layout``): a cooperative launch of up to every
SM the card holds a CTA on, divided among the chains, each CTA a band of
rows with its state in registers, shared or global memory, the column
sums merged through L2 (``grid_scratch``), up to some 58,000 paths.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from .._build import CudaKernel, launch_stream
from .fb_generic import backward_e_plain, forward_e_plain
from .forward_backward import backward_plain, forward_plain

_P = ctypes.c_void_p
_I = ctypes.c_int

# kernel K1: replaces pangenie_tpu/hmm/pallas_fb.py:_fwd_kernel
K1 = CudaKernel("fb", "pg_fb_forward", "fb", [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P])
# K1's 256-thread kernel at any P (which K1 launches past 32 paths): the
# reference that K1's one-warp tier equals bit for bit; chip_smoke.py and
# the card tests launch it, the port's path never does
K1_CTA = CudaKernel("fb", "pg_fb_forward_cta", "fb", K1._argtypes)
# kernel K2: replaces pangenie_tpu/hmm/pallas_fb.py:_bwd_kernel
K2 = CudaKernel(
    "fb", "pg_fb_backward", "fb", [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]
)
# kernel K3: replaces pangenie_tpu/hmm/pallas_fb.py:_fwd_kernel_e
K3 = CudaKernel("fb", "pg_fbe_forward", "fb", [_P] * 6 + [_I] * 6 + [_P])
# kernel K4: replaces pangenie_tpu/hmm/pallas_fb.py:_bwd_kernel_e
K4 = CudaKernel("fb", "pg_fbe_backward", "fb", [_P] * 11 + [_I] * 6 + [_P])

# K1/K2 above 32 paths: a CTA's 256 threads compute the P row sums and P
# column sums in parallel; K3/K4's register tiers give each of 16 warps at
# most 8 rows and each lane at most 4 columns
MAX_PATHS = 128


def fused_threads(P: int, A: int) -> int:
    """The threads a chain of K1 and of K2 for P paths and A alleles (one
    rule for both, mirrors pg_fb_threads in csrc/fb.cu): 32, one warp a
    chain, up to 32 paths and 8 alleles, else a CTA of 256."""
    return 32 if P <= 32 and A <= 8 else 256


# K3/K4's launch (checked again by fbe_config_ok in csrc/fb.cu): shared
# memory one H100 block can use, warps (FBE_WARPS), the slots of the E
# ring (FBE_RING) and the floats of a slot's header
SMEM_BYTES = 232_448
WARPS = 16
RING = 2
_HEADER = 8
# K3/K4's cluster tier (FBE_CLUSTER_* in csrc/fb.cu): clusters of
# CLUSTER_RANKS CTAs a chain (the source's FBE_CLUSTER_RANKS: a library
# built with another, as tools/fbe_times.py --ranks builds them, is
# driven with this set to match), halved while B chains' CTAs outnumber
# the SMS (FBE_SMS) that an H100 holds in clusters at once, never below
# the fewest whose band fits and at most MAX_RANKS; at most
# CLUSTER_CELLS cells a thread of at most CLUSTER_WARPS warps; an E ring
# of CLUSTER_RING slots
CLUSTER_RANKS = 16
MAX_RANKS = 16
CLUSTER_CELLS = 16
CLUSTER_WARPS = 32
CLUSTER_RING = 2
SMS = 112
# K3/K4's grid tier (past the cluster tier, FBG_* and FBE_GRID_* in
# csrc/fb.cu): at most GRID_WARPS warps a CTA, GRID_REG_WARPS of at most
# GRID_CELLS cells a thread with the state in registers, an E ring of
# GRID_RING slots there; one hop of the merge
# where a rank reads at most GRID_ONE_HOP floats of messages. GRID_SMS
# is the source's FBE_GRID_SMS: the CTAs the card holds at once, 0 to ask
# the card (grid_capacity); a library built with another, as the
# emulated tests and tools/fbe_times.py build them, is driven with this
# set to match, as is GRID_ONLY (FBE_GRID_ONLY: no cluster tier)
GRID_WARPS = 32
GRID_REG_WARPS = 16
GRID_CELLS = 32
GRID_RING = 2
GRID_ONE_HOP = 34_000
GRID_SMS = 0
GRID_ONLY = False
# where the grid tier keeps a band's state (FBG_REG, FBG_SMEM, FBG_GLOBAL)
STORES = ("registers", "shared", "global")


class ClusterLayout(NamedTuple):
    """A cluster of ``ranks`` CTAs a chain: the most rows a band has,
    rows a warp, column slots a lane, warps a CTA, shared bytes."""
    ranks: int
    rows: int
    rows_per_warp: int
    columns_per_lane: int
    warps: int
    smem: int


def _cluster_fit(P: int, ranks: int):
    """The layout of P paths in clusters of ``ranks`` (mirrors fbc_layout
    and fbc_smem), or None where a band does not fit: at most
    CLUSTER_CELLS cells a thread of at most CLUSTER_WARPS warps, and the
    shared memory (two mbarriers; the messages of two parities, P column
    partials and the band total in float4s, from every rank; their sums;
    each warp's stage of a message; the E ring of CLUSTER_RING slots of a
    header and a band at any 16-byte misalignment) within one block's."""
    rows = -(-P // ranks)
    per_lane = 8 if P <= 256 else 16
    per_warp = -(-rows // CLUSTER_WARPS)
    warps = -(-rows // per_warp)
    msg = (P + 4) // 4 * 4
    band = (rows * P + 6) // 4 * 4
    smem = 16 + 4 * ((2 * ranks + 1 + warps) * msg + CLUSTER_RING * (_HEADER + band))
    if 32 * per_lane < P or per_warp * per_lane > CLUSTER_CELLS or smem > SMEM_BYTES:
        return None
    return ClusterLayout(ranks, rows, per_warp, per_lane, warps, smem)


def cluster_layout(P: int, B: int) -> Optional[ClusterLayout]:
    """K3/K4's cluster-tier layout for B chains of P paths, None where P
    does not take that tier (mirrors fbe_cluster_layout in csrc/fb.cu):
    past MAX_PATHS, CLUSTER_RANKS CTAs a chain, halved while the chains'
    CTAs outnumber the SMS the card holds in clusters at once, never
    below the fewest (a power of two) whose band fits; None where not
    even MAX_RANKS hold P, and with GRID_ONLY."""
    if P <= MAX_PATHS or GRID_ONLY:
        return None
    least = 1
    while least <= MAX_RANKS and _cluster_fit(P, least) is None:
        least *= 2
    if least > MAX_RANKS:
        return None
    k = max(CLUSTER_RANKS, least)
    while k > least and B * k > SMS:
        k //= 2
    return _cluster_fit(P, k)


class GridLayout(NamedTuple):
    """The grid tier's layout: CTAs a chain, the most rows a band has,
    row groups and segments a row (their product the warps of a CTA),
    column slots a lane, rows a warp, where the state lives (an index of
    STORES), hops of the merge (0 at one CTA), whether the partials live
    in global memory, shared bytes."""
    ctas: int
    rows: int
    groups: int
    segments: int
    columns_per_lane: int
    rows_per_warp: int
    store: int
    hops: int
    global_partials: int
    smem: int


def _round4(x: int) -> int:
    return (x + 3) // 4 * 4


def _grid_floats(P: int, rows: int, groups: int, segments: int):
    """(floats of a message, of a rank's partials): P column partials and
    the total in float4s; the row groups' column partials, the row
    partials of every segment and the row sums (fbg_part_floats)."""
    msg = (P + 4) // 4 * 4
    return msg, groups * msg + _round4(segments * rows) + _round4(rows)


def grid_layout(P: int, B: int, capacity: int) -> Optional[GridLayout]:
    """The grid tier's layout for B chains of P paths where the card
    holds ``capacity`` CTAs at once (mirrors fbg_layout and fbg_smem in
    csrc/fb.cu): G = capacity // B CTAs a chain (1 to P), bands of at
    most ceil(P / G) rows; the state in registers where some number of
    row groups Q (1 to GRID_REG_WARPS, at most the rows) gives at most
    GRID_CELLS cells a thread at 4, 8 or 16 column slots a lane, else in
    shared memory, else in global memory (Q up to GRID_WARPS); within a
    place the fewest cells a thread, then rows a warp, then warps. Q sets
    the slots: the fewest with which (warps // Q) segments span P. Shared
    memory: the column sums, 32 warp totals, the partials (unless in
    global memory, where they do not fit), and the E ring of GRID_RING
    bands at any 16-byte misalignment (registers) or the band (shared
    memory). None at or under MAX_PATHS paths, or where not even the
    column sums fit."""
    if P <= MAX_PATHS or B < 1:
        return None
    G = min(P, max(1, capacity // B))
    rows = -(-P // G)
    hops = 0 if G == 1 else 1 if G * (P + 1) <= GRID_ONE_HOP else 2
    for store in range(len(STORES)):
        best = None
        warps = GRID_REG_WARPS if store == 0 else GRID_WARPS
        for groups in range(1, min(warps, rows) + 1):
            per_lane = -(-P // (32 * (warps // groups)))
            if store == 0:
                per_lane = next((k for k in (4, 8, 16) if per_lane <= k), 0)
                if not per_lane:
                    continue
            segments = -(-P // (32 * per_lane))
            per_warp = -(-rows // groups)
            if store == 0 and per_warp * per_lane > GRID_CELLS:
                continue
            msg, part = _grid_floats(P, rows, groups, segments)
            held = (GRID_RING * ((rows * P + 6) // 4 * 4) if store == 0
                    else _round4(rows * P) if store == 1 else 0)
            gpart = int(store == 2 and 4 * (msg + 32 + part) > SMEM_BYTES)
            smem = 4 * (msg + 32 + (0 if gpart else part) + held)
            if smem > SMEM_BYTES:
                continue
            key = (per_warp * per_lane, per_warp, groups * segments)
            if best is None or key < best[0]:
                best = (key, GridLayout(G, rows, groups, segments, per_lane, per_warp, store,
                                        hops, gpart, smem))
        if best is not None:
            return best[1]
    return None


# the grid tier's capacity by library (pg_fbe_grid_capacity, read once)
_CAPACITY = {}


def grid_capacity(kernel: Optional[CudaKernel] = None) -> int:
    """The CTAs the card holds at once for the grid tier: GRID_SMS where
    set, else the library's reading (the SMs x
    cudaOccupancyMaxActiveBlocksPerMultiprocessor, from the library of
    ``kernel``, default K3's), on the current card."""
    if GRID_SMS:
        return GRID_SMS
    lib = (kernel or K3).lib()
    if id(lib) not in _CAPACITY:
        capacity = ctypes.c_int(0)
        fn = lib.pg_fbe_grid_capacity
        fn.argtypes = [ctypes.POINTER(_I)]
        code = fn(ctypes.byref(capacity))
        if code:
            raise RuntimeError(f"pg_fbe_grid_capacity: CUDA error {code}")
        _CAPACITY[id(lib)] = capacity.value
    return _CAPACITY[id(lib)]


def _grid(P: int, B: int, capacity: Optional[int]) -> GridLayout:
    grid = grid_layout(P, B, grid_capacity() if capacity is None else capacity)
    if grid is None:
        raise ValueError(f"K3/K4's grid tier holds no layout of {P} paths: its column sums "
                         f"exceed one block's shared memory")
    return grid


def generic_launch(P: int, B: int, capacity: Optional[int] = None):
    """(CTAs a chain, threads, dynamic shared bytes) of K3/K4 for B
    chains of P paths (mirrors fbe_config_ok in csrc/fb.cu). Up to
    MAX_PATHS one CTA of WARPS warps; a ring of RING slots, a staging
    column and the reduction scratch. A column is held at any 16-byte
    misalignment; the column partials' pitch is P rounded up to 8 mod
    32. Then the cluster tier (:func:`cluster_layout`). Beyond it the
    grid tier (:func:`grid_layout`, on ``capacity`` CTAs, default the
    card's :func:`grid_capacity`)."""
    cluster = cluster_layout(P, B)
    if cluster is not None:
        return cluster.ranks, 32 * cluster.warps, cluster.smem
    if P > MAX_PATHS:
        grid = _grid(P, B, capacity)
        return grid.ctas, 32 * grid.groups * grid.segments, grid.smem
    column = (P * P + 6) // 4 * 4
    scratch = 4 * (column + WARPS * (P + (8 - P) % 32) + P + 34)
    return 1, 32 * WARPS, scratch + RING * 4 * (_HEADER + column)


def tier(P: int, B: int) -> str:
    """K3/K4's tier for B chains of P paths: "register" (one CTA a chain,
    the state in registers), "cluster" (a cluster of CTAs a chain) or
    "grid" (a cooperative grid of CTAs a chain)."""
    if P <= MAX_PATHS:
        return "register"
    return "cluster" if cluster_layout(P, B) is not None else "grid"


# K3's and K4's launches by tier, grown beside each kernel's own count
# where it launches (chip_smoke.py reads which tier a run took)
TIER_LAUNCHES = {(kernel, t): 0 for kernel in ("K3", "K4")
                 for t in ("register", "cluster", "grid")}


def cluster_fits(P: int, B: int, backward: bool,
                 kernel: Optional[CudaKernel] = None) -> int:
    """cudaOccupancyMaxActiveClusters of K3's (K4's) cluster-tier
    instance for B chains of P paths on the current card, from the
    library of ``kernel`` (default K3's); 0 where P does not take the
    cluster tier."""
    fits = ctypes.c_int(0)
    fn = (kernel or K3).lib().pg_fbe_cluster_fits
    fn.argtypes = [_I, _I, _I, ctypes.POINTER(_I)]
    code = fn(P, B, int(backward), ctypes.byref(fits))
    if code:
        raise RuntimeError(f"pg_fbe_cluster_fits: CUDA error {code}")
    return fits.value


def grid_scratch(B: int, P: int, backward: bool, device,
                 capacity: Optional[int] = None) -> torch.Tensor:
    """The grid tier's scratch in global memory, zeros, per chain
    (mirrors fbg_chain_floats in csrc/fb.cu): its arrival counter (16
    bytes, zero before every launch), the messages of two parities from
    each of its G CTAs and their sums, the partials where they live in
    global memory and, for K4 where the state does, the helper [P, P]
    (K3 keeps its state in its alphas). An empty tensor where P takes a
    register tier or the cluster tier."""
    if tier(P, B) != "grid":
        return torch.empty((0,), dtype=torch.float32, device=device)
    grid = _grid(P, B, capacity)
    msg, part = _grid_floats(P, grid.rows, grid.groups, grid.segments)
    floats = (4 + 2 * (grid.ctas + 1) * msg + grid.global_partials * grid.ctas * part
              + (P * P if backward and STORES[grid.store] == "global" else 0))
    return torch.zeros((B, floats), dtype=torch.float32, device=device)


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _paths_check(P):
    if P > MAX_PATHS:
        raise ValueError(
            f"{P} paths exceed the fused kernels' (K1/K2) limit of {MAX_PATHS}; "
            f"they are reached only through batch.forward_backward_batch, "
            f"which sends such batches to the generic route (K3/K4, any P)"
        )


def _shape_check(ea, allele_local):
    B, N, A, A2 = ea.shape
    P = allele_local.shape[2]
    if A != A2:
        raise ValueError(f"ea must be [B, N, A, A], got {tuple(ea.shape)}")
    _paths_check(P)
    return B, N, P, A


def forward(ea, allele_local, trans, kernel: CudaKernel = K1):
    """(alphas [B, N, P, P], c_fwd [B, N]) — kernel K1 on CUDA tensors
    (``kernel=K1_CTA``: its 256-thread kernel at any P, the same bits)."""
    if ea.device.type == "cpu":
        return forward_plain(ea, allele_local, trans)
    B, N, P, A = _shape_check(ea, allele_local)
    al = allele_local.to(torch.int32).contiguous()
    dev = ea.device
    _check("ea", ea, torch.float32, (B, N, A, A), dev)
    _check("allele_local", al, torch.int32, (B, N, P), dev)
    _check("trans", trans, torch.float32, (B, N, 3), dev)
    alphas = torch.empty((B, N, P, P), dtype=torch.float32, device=dev)
    c_fwd = torch.empty((B, N), dtype=torch.float32, device=dev)
    if B and N:
        kernel(ea.data_ptr(), al.data_ptr(), trans.data_ptr(), alphas.data_ptr(),
               c_fwd.data_ptr(), B, N, P, A, launch_stream(dev))
    return alphas, c_fwd


def backward(alphas, c_fwd, ea, allele_local, trans, is_last):
    """Raw posteriors [B, N, A, A] — kernel K2 on CUDA tensors."""
    if ea.device.type == "cpu":
        return backward_plain(alphas, c_fwd, ea, allele_local, trans, is_last)
    B, N, P, A = _shape_check(ea, allele_local)
    al = allele_local.to(torch.int32).contiguous()
    last = is_last.to(torch.int32).contiguous()     # K2 copies it in 4-byte words
    dev = ea.device
    _check("alphas", alphas, torch.float32, (B, N, P, P), dev)
    _check("c_fwd", c_fwd, torch.float32, (B, N), dev)
    _check("ea", ea, torch.float32, (B, N, A, A), dev)
    _check("allele_local", al, torch.int32, (B, N, P), dev)
    _check("trans", trans, torch.float32, (B, N, 3), dev)
    _check("is_last", last, torch.int32, (B, N), dev)
    posts = torch.empty((B, N, A, A), dtype=torch.float32, device=dev)
    if B and N:
        K2(alphas.data_ptr(), c_fwd.data_ptr(), ea.data_ptr(), al.data_ptr(),
           trans.data_ptr(), last.data_ptr(), posts.data_ptr(), B, N, P, A,
           launch_stream(dev))
    return posts


def forward_e(E, u, alpha0):
    """(alphas [B, n, P, P], c_fwd [B, n]) from precomputed state
    emissions E [B, n, P, P], factored transitions u [B, n, 3] and the
    entry carry alpha0 [B, P, P] — kernel K3 on CUDA tensors."""
    if E.device.type == "cpu":
        return forward_e_plain(E, u, alpha0)
    B, n, P, _ = E.shape
    dev = E.device
    _check("E", E, torch.float32, (B, n, P, P), dev)
    _check("u", u, torch.float32, (B, n, 3), dev)
    _check("alpha0", alpha0, torch.float32, (B, P, P), dev)
    alphas = torch.empty((B, n, P, P), dtype=torch.float32, device=dev)
    c_fwd = torch.empty((B, n), dtype=torch.float32, device=dev)
    if B and n:
        scratch = grid_scratch(B, P, False, dev)
        K3(E.data_ptr(), u.data_ptr(), alpha0.data_ptr(), alphas.data_ptr(),
           c_fwd.data_ptr(), scratch.data_ptr(), B, n, P, *generic_launch(P, B),
           launch_stream(dev))
        TIER_LAUNCHES[("K3", tier(P, B))] += 1
    return alphas, c_fwd


def backward_e(alphas, c_fwd, E, u, E_after, u_after, is_last, beta0):
    """(raw posteriors [B, n, P, P], outgoing beta [B, P, P]) — kernel
    K4 on CUDA tensors; see :func:`fb_generic.backward_e_plain`."""
    if E.device.type == "cpu":
        return backward_e_plain(alphas, c_fwd, E, u, E_after, u_after, is_last, beta0)
    B, n, P, _ = E.shape
    last = is_last.to(torch.int32).contiguous()     # K4 copies it in 4-byte words
    dev = E.device
    _check("alphas", alphas, torch.float32, (B, n, P, P), dev)
    _check("c_fwd", c_fwd, torch.float32, (B, n), dev)
    _check("E", E, torch.float32, (B, n, P, P), dev)
    _check("u", u, torch.float32, (B, n, 3), dev)
    _check("E_after", E_after, torch.float32, (B, P, P), dev)
    _check("u_after", u_after, torch.float32, (B, 3), dev)
    _check("is_last", last, torch.int32, (B, n), dev)
    _check("beta0", beta0, torch.float32, (B, P, P), dev)
    posts = torch.empty((B, n, P, P), dtype=torch.float32, device=dev)
    beta_out = torch.empty((B, P, P), dtype=torch.float32, device=dev)
    if B and n:
        scratch = grid_scratch(B, P, True, dev)
        K4(alphas.data_ptr(), c_fwd.data_ptr(), E.data_ptr(), u.data_ptr(),
           E_after.data_ptr(), u_after.data_ptr(), last.data_ptr(),
           beta0.data_ptr(), posts.data_ptr(), beta_out.data_ptr(),
           scratch.data_ptr(), B, n, P, *generic_launch(P, B), launch_stream(dev))
        TIER_LAUNCHES[("K4", tier(P, B))] += 1
    else:
        beta_out.copy_(beta0)
    return posts, beta_out
