"""The port's kernel bounds (``hmm/bounds.py``), the K3/K4 launch
layout (``fb_kernels.generic_launch``) and S1's layout and memory peak
(``hmm/sampling.py``), on the CPU.

The bounds are held against values worked by hand at the main paths'
shapes and against the bytes of the tensors the plain versions really
take and return; the launch layout against the shared memory one H100
block can use, for every path count the kernels take.
"""

import ctypes

import numpy as np
import pytest
import torch

from pangenie_tpu_torch.hmm import bounds, fb_generic, fb_kernels, sampling


# (work, bytes, least ms) at the main paths' shapes: K1/K2 at the bench
# path's B=2 N=65,536 P=16 A=2, K3/K4 at the SV path's B=1 N=131,072
# P=89, S1 at C=2 N=55,040 P=123
@pytest.mark.parametrize("work,nbytes,ms", [
    # ea 1,048,576 + al 8,388,608 + trans 1,572,864 + alphas 134,217,728
    # + c_fwd 524,288
    (bounds.k1(2, 65536, 16, 2), 146_800_640, 0.0438211),
    # alphas + c_fwd + ea + al + trans + is_last (int32) 524,288 + posts
    # 1,048,576
    (bounds.k2(2, 65536, 16, 2), 149_422_080, 0.0446036),
    # E 4,152,885,248 + u 1,572,864 + alpha0 31,684 + alphas 4,152,885,248
    # + c_fwd 524,288: 8.31 GB
    (bounds.k3(1, 131072, 89), 8_307_899_332, 2.4799700),
    # alphas + E + posts 3 x 4,152,885,248, c_fwd 524,288, u 1,572,864,
    # e_after, beta0, beta_out 3 x 31,684, u_after 12, is_last (int32)
    # 524,288
    (bounds.k4(1, 131072, 89), 12_461_372_248, 3.7198126),
    # path_cost 54,159,360 + mask 13,539,840 + switch 440,320 + paths
    # 440,320 + best 8
    (bounds.s1(2, 55040, 123), 68_579_848, 0.0204716),
    # S1's chase: one uint8 backtrace entry a column 110,080 + ends 8 +
    # paths 440,320
    (bounds.s1_chase(2, 55040, 1), 550_408, 0.000164301),
    # the grid tier at genotype -f -a 600's chunk shape B=2 N=2,048 P=600:
    # E and alphas 2 x 1,474,560,000 + u 49,152 + alpha0 2,880,000 + c_fwd
    # 16,384 (11.8 GB)
    (bounds.k3(2, 2048, 600), 11_799_425_536, 3.5222166),
    # alphas, E, posts 3 x 5,898,240,000, c_fwd 16,384, u 49,152, e_after,
    # beta0, beta_out 3 x 2,880,000, u_after 24, is_last 16,384
    (bounds.k4(2, 2048, 600), 17_703_441_944, 5.2846095),
    # V1 at the bench run's phasing batch B=2 N=65,536 P=16 A=4: logea
    # 8,388,608 + al 8,388,608 + lt 1,572,864 + carry in and out 2 x 2,048
    # + first 8 + backtraces (int16) 67,108,864 + states 524,288 +
    # state_in and state_out 2 x 8
    (bounds.v1(2, 65536, 16, 4), 85_987_352, 0.02566787),
    # D1 over a block of 48,000,000 bases: words 12,000,000 + vwords
    # 6,000,000 + keys 384,000,000; D1-count into 24,000,000 keys: the
    # block, table 192,000,000, counts in and out 192,000,000 (not the
    # directory, the kernel's own)
    (bounds.d1_extract(48_000_000), 402_000_000, 0.1200000),
    (bounds.d1_count(48_000_000, 24_000_000, 400_000_000), 402_000_000, 0.1200000),
    # D1-count-keys: 20,000,000 routed keys (int64) 160,000,000 into a
    # partition of 15,000,000 keys that they cover: table 120,000,000,
    # counts in and out 120,000,000
    (bounds.d1_count_keys(20_000_000, 15_000_000, 60_000_000, 18_000_000, 15_000_000),
     400_000_000, 0.1194030),
    # and 40,000,000 keys into a partition of 700,000,000, 37,000,000 of
    # them distinct, 35,000,000 found: the keys 320,000,000, the table's
    # entries they need 296,000,000, their counts 280,000,000
    (bounds.d1_count_keys(40_000_000, 700_000_000, 90_000_000, 37_000_000, 35_000_000),
     896_000_000, 0.2674627),
    # D1-route: a block of 31,000,000 keys (int64) 248,000,000, of which
    # 30,000,000 valid written binned 240,000,000, into 2 owners x 2^8
    # regions: sizes (int64) 4,096
    (bounds.d1_route(31_000_000, 30_000_000, 512), 488_004_096, 0.1456729),
], ids=["K1", "K2", "K3", "K4", "S1", "S1_chase", "K3_grid", "K4_grid", "V1", "D1_extract",
        "D1_count", "D1_count_keys", "D1_count_keys_sparse", "D1_route"])
def test_bytes_and_bound_at_main_shapes(work, nbytes, ms):
    assert work.nbytes == nbytes
    got_ms, by = work.bound()
    assert by == "bytes"
    assert got_ms == pytest.approx(ms, rel=1e-6)


def test_operations_bound_when_bytes_are_few():
    assert bounds.Work(nbytes=0, ops=67_000_000).bound() == pytest.approx((0.001, "operations"))


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def _table_reads(table, key: int, scan: int) -> int:
    """The table reads D1-count's search makes for one valid key, step by
    step as csrc/kmer_count.cu takes them: binary steps while its range
    holds more than ``scan`` keys, then the pairs from the range's even
    neighbour."""
    directory, keys = table.directory.tolist(), table.keys.tolist()
    lo, hi = directory[key >> table.shift], directory[(key >> table.shift) + 1]
    steps = 0
    while hi - lo > scan:
        mid = lo + (hi - lo) // 2
        lo, hi = (mid, hi) if keys[mid] <= key else (lo, mid)
        steps += 1
    return steps + len(range(lo & ~1, hi, 2))


def test_d1_bytes_and_steps_match_the_plain_versions():
    """D1's byte counts are the bytes of the block, table keys and counts
    that the plain versions read (counts twice: read and written; the
    plain count reads no directory) and of the keys D1-extract returns;
    its search steps are the table reads its search makes, at the rule's
    directory and at one of 4 bits whose buckets are narrowed first, and
    at a scan of 8 keys as at the default."""
    from pangenie_tpu_torch.kmers import device_counter as dc

    rng = np.random.default_rng(2)
    seqs = [bytes(rng.choice(list(b"ACGT"), 70).astype(np.uint8)) for _ in range(40)]
    offsets = np.concatenate([[0], np.cumsum([len(x) for x in seqs])])
    words, vwords, T = dc.pack_sequences(np.frombuffer(b"".join(seqs), np.uint8),
                                         offsets[:-1], np.diff(offsets))
    words, vwords = (torch.from_numpy(x.view(np.int32)) for x in (words, vwords))
    keys = dc.extract_plain(words, vwords, T, 11)
    table_keys = torch.unique(keys[keys != dc.SENTINEL])[::2].contiguous()
    counts = torch.zeros(table_keys.shape, dtype=torch.int32)
    assert bounds.d1_extract(T).nbytes == _nbytes(words, vwords, keys)
    for d, scan in ((dc.directory_bits(len(table_keys), 11), dc.SCAN), (4, dc.SCAN), (4, 8)):
        table = dc.make_table(table_keys, 11, d)
        steps = dc.search_steps(table, keys, scan)
        assert bounds.d1_count(T, len(table.keys), steps).nbytes == _nbytes(
            words, vwords, table.keys, counts, counts)
        reads = [_table_reads(table, key, scan) for key in keys[keys != dc.SENTINEL].tolist()]
        assert steps == sum(reads) > 0
        assert d != 4 or max(reads) > 1 + scan // 2


def test_d1_count_keys_bytes_and_steps_match_the_plain_version():
    """D1-count-keys' byte count is the bytes of the keys, table keys and
    counts (read and written) that its plain version takes where the
    keys cover the table, and what they touch where they do not; its
    search steps are D1-count's for the same valid keys."""
    from pangenie_tpu_torch.kmers import device_counter as dc

    rng = np.random.default_rng(4)
    keys = torch.from_numpy(rng.integers(0, 4 ** 13, 3000, dtype=np.int64))
    table = dc.make_table(torch.unique(keys[::3]), 13)
    counts = torch.zeros(table.keys.shape, dtype=torch.int32)
    steps = dc.search_steps(table, keys)
    dc.count_keys_plain(keys, table, counts)
    distinct, found = len(torch.unique(keys)), int((counts > 0).sum())
    assert distinct > len(table.keys) == found
    work = bounds.d1_count_keys(len(keys), len(table.keys), steps, distinct, found)
    assert work.nbytes == _nbytes(keys, table.keys, counts, counts)
    # queries that cover a tenth of a table need a tenth of it
    few = keys[:100]
    sparse = torch.zeros_like(counts)
    dc.count_keys_plain(few, table, sparse)
    touched = bounds.d1_count_keys(len(few), len(table.keys), dc.search_steps(table, few),
                                   len(torch.unique(few)), int((sparse > 0).sum()))
    assert touched.nbytes == 8 * 100 + 8 * len(torch.unique(few)) + 8 * int((sparse > 0).sum())
    assert touched.nbytes < _nbytes(few, table.keys, counts, counts)
    reads = [_table_reads(table, key, dc.SCAN) for key in keys.tolist()]
    assert steps == sum(reads) > 0
    assert work.ops == bounds.D1_KEY_OPS * len(keys) + bounds.D1_SEARCH_OPS * steps


def test_d1_route_bytes_match_the_plain_version():
    """D1-route's byte count is the bytes of the keys its plain version
    takes and of the binned keys and sizes it returns; its two passes
    move the keys twice, the binned keys once and the CTAs' counts four
    times (device_counter.route_ctas)."""
    from pangenie_tpu_torch.kmers import device_counter as dc

    rng = np.random.default_rng(5)
    keys = torch.from_numpy(rng.integers(0, 4 ** 21, 5000, dtype=np.int64))
    keys[::9] = dc.SENTINEL
    binned, sizes = dc.route_plain(keys, 21, 4, 6)
    work = bounds.d1_route(len(keys), len(binned), sizes.numel())
    assert work.nbytes == _nbytes(keys, binned, sizes)
    assert work.ops == bounds.D1_ROUTE_OPS * len(keys)
    ctas = dc.route_ctas(len(keys), sizes.numel())
    assert ctas == 5
    assert bounds.d1_route_passes(len(keys), len(binned), 256, ctas) == (
        2 * 8 * 5000 + 8 * len(binned) + 4 * 4 * 5 * 256 + 4 * 8 * 256)
    # at the SV block's 31 M keys: two CTAs an SM past ROUTE_FRONTIER
    # open lines, up to ROUTE_MAX_CTAS below it
    assert dc.route_ctas(31_000_000, 4 << 12) == dc.ROUTE_MIN_CTAS == 264
    assert dc.route_ctas(31_000_000, 2 << 6) == dc.ROUTE_FRONTIER // (2 << 6) == 1024
    assert dc.route_ctas(31_000_000, 4) == dc.ROUTE_MAX_CTAS


def test_generic_bytes_match_the_plain_versions_tensors():
    """K3/K4's byte counts are the bytes of what their plain versions
    take and return (is_last as the int32 K4 copies)."""
    B, n, P = 2, 5, 7
    rng = np.random.default_rng(0)

    def rand(*shape):
        return torch.from_numpy(rng.random(shape).astype(np.float32))

    E, alpha0, beta0, e_after, u_after = (rand(B, n, P, P), rand(B, P, P), rand(B, P, P),
                                          rand(B, P, P), rand(B, 3))
    u = fb_generic.factor_trans(rand(B, n, 3)).contiguous()
    last = torch.zeros((B, n), dtype=torch.int32)
    alphas, c_fwd = fb_kernels.forward_e(E, u, alpha0)
    assert bounds.k3(B, n, P).nbytes == _nbytes(E, u, alpha0, alphas, c_fwd)
    posts, beta_out = fb_kernels.backward_e(alphas, c_fwd, E, u, e_after, u_after,
                                            last, beta0)
    assert bounds.k4(B, n, P).nbytes == _nbytes(
        alphas, c_fwd, E, u, e_after, u_after, last, beta0, posts, beta_out)


# (CTAs a chain, threads, shared bytes) for B=11 chains. P=89: a column
# of 7,924 floats (P^2 + 3, rounded up to float4s), the partials' pitch
# 104; 4 x (2 x (8 + 7,924) + 7,924 + 16 x 104 + 89 + 34). P=129: 8 CTAs,
# bands of 17 rows, one warp a row: 16 + 4 x ((2 x 8 + 1 + 17) x 132 + 2 x
# (8 + 2,196)). P=200: 8 CTAs of 25 warps, 16 + 4 x (42 x 204 + 2 x (8 +
# 5,004)). P=465: 16 CTAs of 30 warps, 16 + 4 x (63 x 468 + 2 x (8 +
# 13,956)). Past 471 paths the grid tier on an H100's 132 CTAs at once, 12
# a chain of the 11: at P=472 bands of 40 rows in shared memory, 10 row
# groups of 3 segments of 5 column slots a lane (30 warps), 4 x (476 + 32 +
# 10 x 476 + 120 + 40 + 40 x 472); at 6405 bands of 534 rows in global
# memory, 32 warps of 201 slots a lane, the partials in global memory
# too (32 x 6,408 of them do not fit), 4 x (6,408 + 32)
@pytest.mark.parametrize("P,launch", [
    (1, (1, 512, 764)), (16, (1, 512, 5_944)), (89, (1, 512, 102_300)),
    (128, (1, 512, 206_072)), (129, (8, 544, 35_600)), (6405, (12, 1024, 25_760)),
    (200, (8, 800, 74_384)), (465, (16, 960, 229_664)), (472, (12, 960, 97_232)),
])
def test_generic_launch_at_known_path_counts(P, launch):
    assert fb_kernels.generic_launch(P, 11, capacity=132) == launch


def test_generic_launch_fits_every_path_count():
    """For P = 1..128: 16 warps, an E ring of 2 columns, and ring plus
    staging column plus scratch within one H100 block's 232,448 bytes of
    shared memory."""
    assert fb_kernels.RING == 2
    for P in range(1, fb_kernels.MAX_PATHS + 1):
        ranks, threads, smem = fb_kernels.generic_launch(P, 1)
        assert ranks == 1
        assert threads == 32 * fb_kernels.WARPS == 512
        column = P * P + 3 + (-(P * P + 3)) % 4          # float4s
        pitch = P + (8 - P) % 32
        assert pitch >= P and pitch % 32 == 8
        assert smem == 4 * (2 * (8 + column) + column + 16 * pitch + P + 34)
        assert smem <= fb_kernels.SMEM_BYTES == 232_448


# (CTAs, warps a CTA, paths a lane, backtrace row) and backtrace bytes:
# one CTA of one warp up to 128 paths, of warps of 4 paths a lane up to
# 1024; then clusters of up to 8 CTAs of the warps of 4 paths a lane that
# 8 CTAs need, of up to 16 past 32,768 paths, as few CTAs as hold the
# paths, up to 65,536; then one CTA of 32 warps of ceil(P/1024);
# uint8 up to 256 paths, 16 bits up to 65,536, then 32
@pytest.mark.parametrize("P,layout,bt_bytes", [
    (1, (1, 1, 1, 32), 1), (32, (1, 1, 1, 32), 1), (33, (1, 1, 2, 64), 1),
    (65, (1, 1, 3, 96), 1), (123, (1, 1, 4, 128), 1), (128, (1, 1, 4, 128), 1),
    (129, (1, 2, 4, 256), 1), (256, (1, 2, 4, 256), 1), (257, (1, 3, 4, 384), 2),
    (1024, (1, 8, 4, 1024), 2), (1025, (5, 2, 4, 1280), 2), (2049, (6, 3, 4, 2304), 2),
    (4096, (8, 4, 4, 4096), 2), (4097, (7, 5, 4, 4480), 2), (6405, (8, 7, 4, 7168), 2),
    (8193, (8, 9, 4, 9216), 2), (16385, (8, 17, 4, 17408), 2),
    (32768, (8, 32, 4, 32768), 2), (32769, (16, 17, 4, 34816), 2),
    (65536, (16, 32, 4, 65536), 2), (65537, (1, 32, 65, 66560), 4),
])
def test_s1_sweep_layout(P, layout, bt_bytes):
    assert sampling.sweep_layout(P) == layout
    assert torch.empty((), dtype=sampling.backtrace_dtype(P)).element_size() == bt_bytes


def test_s1_sweep_layout_for_every_path_count():
    """For P = 1..16,384: a row holds every path and at most one lane's
    worth more a CTA; at most 32 warps a CTA; 4 paths a lane from 129
    paths on; past 1024 a cluster of up to 8 CTAs of 2-32 warps, in path
    order, the padding at the row's end and less than one CTA's paths, so
    that no CTA holds only padding."""
    for P in range(1, 16_385):
        ranks, warps, per_lane, row = sampling.sweep_layout(P)
        assert row == ranks * 32 * warps * per_lane and P <= row
        assert 1 <= warps <= 32
        if P <= 128:
            assert (ranks, warps) == (1, 1) and row - P < 32
        elif P <= sampling.CTA_PATHS:
            assert ranks == 1 and per_lane == 4 and row - P < 128
        else:
            slice_ = row // ranks
            assert 2 <= ranks <= 8 and warps == -(-P // 1024) and per_lane == 4
            assert row - P < slice_ and (P - 1) // slice_ == ranks - 1
        assert sampling.backtrace_dtype(P) == (torch.uint8 if P <= 256 else torch.int16)


# the layouts of the source built with S1_CLUSTER_RANKS = ranks (as
# tools/s1_times.py --ranks builds it), which sampling.CLUSTER_RANKS
# follows; None: no instance takes it (CTAs of one warp)
ASKED_FOR = {(6405, 1): (13, 4, 4, 6656), (6405, 4): (4, 13, 4, 6656),
             (6405, 16): (13, 4, 4, 6656), (2049, 2): (2, 9, 4, 2304),
             (2049, 4): (4, 5, 4, 2560), (1000, 16): (1, 8, 4, 1024),
             (1000, 8): (1, 8, 4, 1024), (300, 2): (1, 3, 4, 384), (1025, 16): None}


@pytest.mark.parametrize("P,ranks", list(ASKED_FOR))
def test_s1_sweep_layout_asked_for(monkeypatch, P, ranks):
    """Another S1_CLUSTER_RANKS gives each CTA the warps of 4 paths a
    lane that that many CTAs need (16 past that many CTAs of 32 warps),
    then as few CTAs as hold the paths, where an instance takes it (2-32
    warps); up to 1024 paths one CTA, whatever the build."""
    monkeypatch.setattr(sampling, "CLUSTER_RANKS", ranks)
    if ASKED_FOR[P, ranks] is None:
        with pytest.raises(ValueError, match="no cluster"):
            sampling.sweep_layout(P)
    else:
        assert sampling.sweep_layout(P) == ASKED_FOR[P, ranks]


def test_s1_chase_segments():
    assert [sampling.chase_segment(n) for n in (1, 2, 4, 5, 37, 55040, 2_300_000)] == [
        1, 2, 2, 3, 7, 235, 1517]


def test_sampling_group_peak_bytes():
    """C=2, N=100, P=9, A=3, 4 iterations: 200 columns, 1,800 cells.
    Held: 200 x (costs and their copy 24 + switch 4 + valid 1 + paths 16)
    + 1,800 x (alleles 4 + path_cost 4 + used 1) = 25,200. On top the
    update's selection 1,800 + 200 x 64 (14,600) exceeds S1's mask 1,800
    + backtraces 200 x 32 + maps 2 x 10 x 9 x 4 + paths 200 x 16
    (12,120) and the first gather's int32 index of one chromosome
    (3,600). With one iteration 12 bytes of paths less a column. The long
    chromosome of chip_smoke.py (N=2,300,000, P=123, A=4, 2 iterations):
    held 2.65 GB, S1's 0.61 GB on top: 3.26 GB, 11.54 bytes a cell (38.37
    with int64 alleles and penalty temporaries)."""
    assert sampling.group_peak_bytes(2, 100, 9, 3, 4) == 39_800
    assert sampling.group_peak_bytes(2, 100, 9, 3, 1) == 37_400
    assert sampling.group_peak_bytes(1, 2_300_000, 123, 4, 2) == 3_264_446_364


@pytest.mark.parametrize("ranks", [1, 4, 8, 16])
def test_s1_bound_does_not_depend_on_the_layout(monkeypatch, ranks):
    """S1's bound at the widest panel's shape (C=1 N=5,506 P=6,405) is
    the same for every layout of its sweep, the clusters of 13, 4, 8 and
    13 CTAs of builds with S1_CLUSTER_RANKS = 1, 4, 8 (the rule) and 16,
    whose rows (6656, 6656, 7168, 6656 entries) differ from the parent's
    one CTA of 32 warps (7168): the backtraces are the kernel's own
    scratch, and the bytes and operations are those of the function (5
    bytes a cell in, the switch in, the path and best out), 0.0526 ms by
    bytes."""
    C, N, P = 1, 5506, 6405
    monkeypatch.setattr(sampling, "CLUSTER_RANKS", ranks)
    ctas, _warps, _per_lane, row = sampling.sweep_layout(P)
    assert (ctas, row) == {1: (13, 6656), 4: (4, 6656), 8: (8, 7168), 16: (13, 6656)}[ranks]
    work = bounds.s1(C, N, P)
    assert work.nbytes == 5 * N * P + 8 * N + 4 == 176_373_702
    ms, by = work.bound()
    assert by == "bytes" and ms == pytest.approx(0.0526489, rel=1e-5)


def test_s1_seg_bound():
    """The checkpointed scan moves S1's bytes (the same function) and
    does the forward pass's operations over every segment but the last
    on top: N=2,300,000 P=6405 in segments of 500,000 sweeps 2,000,000
    columns forward."""
    C, N, P = 1, 2_300_000, 6405
    work = bounds.s1_seg(C, N, P, 500_000)
    assert work.nbytes == bounds.s1(C, N, P).nbytes == 5 * N * P + 8 * N + 4
    assert work.ops == bounds.S1_OPS * P * (N + 2_000_000)
    assert bounds.s1_seg(C, N, P, N).ops == bounds.s1(C, N, P).ops
    ms, by = work.bound()
    assert by == "bytes" and ms == pytest.approx(work.nbytes / 3.35e12 * 1e3)


def test_segment_columns_fit_the_budget():
    """The longest segment whose backtraces, the source's bytes, the
    path, the chase maps and the entry rows fit 15/16 of the budget;
    raises where not one column does."""
    C, N, P, per = 1, 100_000, 2049, 10 * 2049
    budget = 200 << 20
    L = sampling.segment_columns(budget, C, N, P, per)
    row = sampling.sweep_layout(P)[3]

    def need(L):
        return (L * (per + C * (row * 2 + 8)) + 4 * C * N
                + 4 * C * P * (316 + 6 + -(-N // L)))

    assert need(L) <= budget - budget // 16 < need(L + 2)
    assert sampling.segment_columns(1 << 40, C, N, P, per) == N
    with pytest.raises(RuntimeError, match="does not fit"):
        sampling.segment_columns(1000, C, N, P, per)


def test_generic_launch_past_128_paths():
    """For P = 129..1,024 and at 6,405 (the 1000 Genomes panel's paths):
    up to 471 paths the cluster tier, for B=11 clusters of 8 CTAs up to
    256 paths and of 16 beyond, each CTA a band of floor(P / K) or ceil(P / K) rows
    in at most 16 cells a thread (one warp a row, lanes over 8 or 16
    column slots), its shared memory within one H100 block's and no
    scratch; past it the grid tier on an H100's 132 CTAs at once, 12 a
    chain, rows spread over at most 32 warps whose segments cover P, at
    most 16 cells a thread where the band is in registers, and its
    scratch per chain; the register tiers take none."""
    for P in [*range(fb_kernels.MAX_PATHS + 1, 1025), 6405]:
        ranks, threads, smem = fb_kernels.generic_launch(P, 11, capacity=132)
        layout = fb_kernels.cluster_layout(P, 11)
        assert smem <= fb_kernels.SMEM_BYTES
        if P <= 471:
            assert ranks == (8 if P <= 256 else 16) == layout.ranks
            assert layout.rows == -(-P // ranks) <= 32
            assert layout.rows_per_warp == 1 and threads == 32 * layout.rows
            assert layout.columns_per_lane == (8 if P <= 256 else 16) >= P / 32
            assert smem == layout.smem
            assert fb_kernels.grid_scratch(11, P, True, "cpu").numel() == 0
        else:
            grid = fb_kernels.grid_layout(P, 11, 132)
            assert layout is None and fb_kernels.tier(P, 11) == "grid"
            assert ranks == grid.ctas == 12 and grid.rows == -(-P // 12)
            assert threads == 32 * grid.groups * grid.segments <= 1024
            assert 32 * grid.columns_per_lane * grid.segments >= P
            assert grid.rows_per_warp * grid.groups >= grid.rows
            if fb_kernels.STORES[grid.store] == "registers":
                assert grid.rows_per_warp * grid.columns_per_lane <= fb_kernels.GRID_CELLS
            assert smem == grid.smem and grid.hops == (1 if 12 * (P + 1) <= 34_000 else 2)
    msg = 604                                       # 601 floats in float4s
    for B, ctas in ((1, 132), (2, 66)):
        shape = (B, 4 + 2 * (ctas + 1) * msg)       # counter, messages and sums
        assert fb_kernels.grid_scratch(B, 600, True, "cpu", 132).shape == shape
        assert not fb_kernels.grid_scratch(B, 600, True, "cpu", 132).any()
    # one CTA a chain of 6405 paths: the partials (32 x 6,408 + 6,405 +
    # 6,408 floats) in global memory, and K4's helper
    part = 32 * 6408 + 6408 + 6408
    assert fb_kernels.grid_scratch(3, 6405, False, "cpu", 3).shape == (3, 4 + 4 * 6408 + part)
    assert fb_kernels.grid_scratch(3, 6405, True, "cpu", 3).shape == (
        3, 4 + 4 * 6408 + part + 6405 * 6405)
    assert fb_kernels.grid_scratch(3, 128, True, "cpu").numel() == 0


@pytest.mark.parametrize("P,B,ranks", [
    (200, 1, 16), (200, 7, 16), (200, 8, 8), (200, 11, 8), (200, 14, 8), (200, 15, 4),
    (200, 28, 4), (200, 29, 4), (200, 400, 4), (129, 15, 4), (256, 40, 4), (257, 2, 16),
    (465, 2, 16), (465, 20, 16),
])
def test_cluster_ranks_by_batch(P, B, ranks):
    """The rule's CTAs a chain: CLUSTER_RANKS (16), halved while B
    chains' CTAs would outnumber the 112 SMs an H100 holds in clusters at
    once, never below the fewest whose band fits 16 cells a thread (4 up
    to 256 paths, 16 beyond)."""
    assert fb_kernels.cluster_layout(P, B).ranks == ranks


@pytest.mark.parametrize("k,ranks", [(1, (4, 16)), (2, (4, 16)), (4, (4, 16)),
                                     (8, (8, 16))])
def test_cluster_ranks_of_other_builds(monkeypatch, k, ranks):
    """A library built with FBE_CLUSTER_RANKS = k (tools/fbe_times.py
    --ranks) takes k CTAs a chain where a band fits, else the fewest that
    hold one: at P = 200 and 465, B=2."""
    monkeypatch.setattr(fb_kernels, "CLUSTER_RANKS", k)
    assert (fb_kernels.cluster_layout(200, 2).ranks,
            fb_kernels.cluster_layout(465, 2).ranks) == ranks


def test_k2_bytes_match_the_tensors_it_takes():
    """K2's byte count is the bytes of the tensors the wrapper hands the
    kernel (is_last as the int32 it copies) and of its posteriors."""
    from pangenie_tpu_torch.hmm.forward_backward import forward_plain

    B, N, P, A = 2, 6, 5, 3
    rng = np.random.default_rng(1)
    ea = torch.from_numpy(rng.random((B, N, A, A)).astype(np.float32))
    al = torch.from_numpy(rng.integers(0, A, (B, N, P)).astype(np.int32))
    trans = torch.from_numpy(rng.random((B, N, 3)).astype(np.float32))
    last = torch.zeros((B, N), dtype=torch.int32)
    alphas, c_fwd = forward_plain(ea, al, trans)
    posts = fb_kernels.backward(alphas, c_fwd, ea, al, trans, last)
    assert bounds.k2(B, N, P, A).nbytes == _nbytes(alphas, c_fwd, ea, al, trans, last,
                                                   posts)


def test_k1_bytes_match_the_tensors_it_takes():
    """K1's byte count is the bytes of the tensors the wrapper hands the
    kernel (allele_local as the int32 it copies) and of its outputs."""
    from pangenie_tpu_torch.hmm.forward_backward import forward_plain

    B, N, P, A = 2, 6, 5, 3
    rng = np.random.default_rng(2)
    ea = torch.from_numpy(rng.random((B, N, A, A)).astype(np.float32))
    al = torch.from_numpy(rng.integers(0, A, (B, N, P)).astype(np.int32))
    trans = torch.from_numpy(rng.random((B, N, 3)).astype(np.float32))
    alphas, c_fwd = forward_plain(ea, al, trans)
    assert bounds.k1(B, N, P, A).nbytes == _nbytes(ea, al, trans, alphas, c_fwd)


@pytest.fixture(scope="module")
def fb_rule(tmp_path_factory):
    """csrc/fb.cu built against the CUDA emulator (test_torch_fb_emulated),
    for its host-side layout rules."""
    from test_torch_fb_emulated import _build_emulated

    lib = _build_emulated(tmp_path_factory.mktemp("fb_rule"))
    lib.pg_fbe_grid_layout.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    return lib


@pytest.mark.parametrize("capacity", [1, 4, 24, 132])
def test_grid_layout_matches_the_c_rule(fb_rule, capacity):
    """fb_kernels.grid_layout is csrc/fb.cu's fbg_layout and fbg_smem
    (pg_fbe_grid_layout) for every P from 472 to 2,100 and several B,
    on cards that hold 1, 4, 24 and 132 CTAs at once: the CTAs a chain,
    the band's rows, row groups, segments, slots a lane, rows a warp,
    where the state lives, hops, partials in global memory, shared
    bytes."""
    out = (ctypes.c_int * 10)()
    for B in (1, 2, 3, 7, 11, 40):
        for P in range(472, 2101):
            assert fb_rule.pg_fbe_grid_layout(P, B, capacity, out) == 1
            assert tuple(out) == tuple(fb_kernels.grid_layout(P, B, capacity)), (P, B)


@pytest.mark.parametrize("P,B,ctas,store,hops", [
    (600, 2, 66, "registers", 2), (1025, 1, 132, "registers", 2), (2049, 1, 132, "shared", 2),
    (472, 3, 44, "registers", 1), (6405, 1, 132, "global", 2), (600, 4, 33, "registers", 1),
])
def test_grid_layout_at_the_main_shapes(P, B, ctas, store, hops):
    """The grid tier on an H100 (132 CTAs at once): the `-a 600` chunk's
    two chains on 66 CTAs each (bands of 9-10 rows in registers, 5 row
    groups of 3 segments, 16 cells a thread, two hops); P=1025 and 2049 on
    all 132 (bands of 7-8 rows in registers, of 15-16 in shared memory);
    one hop where G (P + 1) floats are few."""
    grid = fb_kernels.grid_layout(P, B, 132)
    assert (grid.ctas, fb_kernels.STORES[grid.store], grid.hops) == (ctas, store, hops)
    if (P, B) == (600, 2):
        assert (grid.rows, grid.groups, grid.segments, grid.columns_per_lane,
                grid.rows_per_warp) == (10, 5, 3, 8, 2)


@pytest.mark.parametrize("P,A,threads", [(32, 8, 32), (33, 8, 256), (32, 9, 256),
                                         (33, 9, 256), (1, 1, 32), (16, 4, 32)])
def test_fused_tier_rule(fb_rule, P, A, threads):
    """K1's and K2's tier, one rule for both: one warp a chain up to 32
    paths and 8 alleles, else a CTA of 256 threads. fb_kernels.fused_threads
    is csrc/fb.cu's pg_fb_threads, which pg_fb_forward and pg_fb_backward
    both read."""
    assert fb_rule.pg_fb_threads(P, A) == fb_kernels.fused_threads(P, A) == threads


def test_fused_tier_rule_for_every_shape(fb_rule):
    """fb_kernels.fused_threads is pg_fb_threads for every P up to 128 and
    A up to 16."""
    for P in range(1, 129):
        for A in range(1, 17):
            assert fb_rule.pg_fb_threads(P, A) == fb_kernels.fused_threads(P, A), (P, A)


@pytest.mark.parametrize("backtrace", [True, False])
def test_v1_bytes_match_the_tensors_it_takes(backtrace):
    """V1's byte count is the bytes of the tensors its wrapper hands the
    kernel (alleles and first as int32, the backtraces without their two
    spare entries) and gets back."""
    from pangenie_tpu_torch.hmm import v1_kernels
    from pangenie_tpu_torch.hmm.viterbi import Inputs

    B, N, P, A = 3, 7, 5, 4
    inputs = Inputs(torch.zeros((B, N, A, A)), torch.zeros((B, N, P), dtype=torch.int64),
                    torch.zeros((B, N, 3)))
    carry, first = torch.zeros((B, P * P)), torch.ones((B,), dtype=torch.bool)
    inputs, carry, first = v1_kernels.checked_inputs(inputs, carry, first)
    out = v1_kernels.launch(inputs, carry, first, None, backtrace, kernel=lambda *a: None)
    taken = _nbytes(*inputs, carry, first, out.carry)
    if backtrace:
        taken += _nbytes(out.bt, out.states, out.state_out, torch.zeros((B,), dtype=torch.int32))
    assert bounds.v1(B, N, P, A, backtrace).nbytes == taken
    assert bounds.v1(B, N, P, A).ops == bounds.V1_OPS * B * N * P * P
