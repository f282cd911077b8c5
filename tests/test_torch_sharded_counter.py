"""The partitioned read k-mer counter over the ranks of a process group
(``kmers/device_counter.py``: ``ShardedPrimedDeviceCounter``,
``count_stream_sharded``, ``count_file_primed_sharded``, and COUNT mode's
``sharded_count_kmers`` and ``sharded_count_kmers_partitioned``) against
the JAX package's counterparts on as many of the conftest's virtual CPU
devices, and against the host engine: tests/test_sharded_counter.py
mirrored at 1, 2 and 3 ranks (gloo process groups of spawned CPU
processes, D1's plain versions), exactly, since counts are integers.

Each rank holds the partition of the graph keys that the reference's
``_owner_mix`` gives its device, and the partitions must be the
reference's (its ``_per_dev`` and the keys its ``_order`` puts on the
device). ``test_overflow_detection`` has no
counterpart: the port's exchange sends each rank exactly the keys it
owns, sizes first, so nothing is binned into a fixed capacity and
nothing can overflow.
"""

import os

import numpy as np
import pytest

from pangenie_tpu_torch.kmers.counter import ExactKmerCounter
from test_torch_distributed import run_ranks

LUT = np.frombuffer(b"ACGT", dtype=np.uint8)
WORLDS = [1, 2, 3]


def _genome_and_keys(k, n_bases, seed=0):
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, size=n_bases).astype(np.uint8)
    keys = np.unique(ExactKmerCounter._extract_canonical([LUT[genome].tobytes()], k))
    return genome, keys


def _reads(genome, n_reads, read_len, seed=1, with_ns=False):
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, len(genome) - read_len, size=n_reads)
    reads = genome[starts[:, None] + np.arange(read_len)[None, :]].copy()
    if with_ns:
        reads[rng.random(reads.shape) < 0.01] = 4
    return reads


def _texts(reads):
    return [np.where(r == 4, ord("N"), LUT[np.minimum(r, 3)]).astype(np.uint8).tobytes()
            for r in reads]


def _host_counts(k, keys, texts):
    """Ground truth: canonical windows of the reads against the keys."""
    kmers = ExactKmerCounter._extract_canonical(texts, k)
    counts = np.zeros(len(keys), np.int64)
    uk, uc = np.unique(kmers, return_counts=True)
    pos = np.searchsorted(keys, uk)
    hit = pos < len(keys)
    hit[hit] = keys[pos[hit]] == uk[hit]
    counts[pos[hit]] = uc[hit]
    return counts


def _variable_reads(k, seed):
    genome, keys = _genome_and_keys(k, 50_000, seed=seed)
    rng = np.random.default_rng(seed + 1)
    lens = rng.integers(k, 400, size=300)
    starts = rng.integers(0, len(genome) - 400, size=300)
    return genome, keys, [genome[s:s + n] for s, n in zip(starts, lens)]


def _write_fasta(path, texts):
    with open(path, "w") as f:
        for i, t in enumerate(texts):
            f.write(f">r{i}\n{t.decode()}\n")


def counter_rank(workdir):
    """Every case at this rank; what each gave."""
    import torch

    from pangenie_tpu_torch import commands
    from pangenie_tpu_torch.kmers import device_counter as dc
    from pangenie_tpu_torch.parallel import distributed as dist

    rank, world = dist.process_index(), dist.process_count()
    out = {"rank": rank}
    # the owners of a given table computed in many chunks; regions at
    # these small tables' sizes (2-4 bits for 200,000 keys)
    dc.OWNER_CHUNK = 5000
    dc.REGION_SHIFT = 14

    # the batch counter, with and without N's, in batches of 128 reads
    # whose rows split over the ranks; with N's, each step's bins as
    # D1-route's wrapper gave them and route_plain gives them, and the
    # runs and keys the exchange brought here
    genome, keys = _genome_and_keys(31, 200_000)
    steps = []
    route, exchange = dc.route, dist.all_to_all_bins

    def route_kept(block, k, n_ranks, r, **kw):
        binned, sizes = route(block, k, n_ranks, r, **kw)
        plain = dc.route_plain(block, k, n_ranks, r)
        steps.append({"sent": sizes.numpy().copy(), "plain": plain[1].numpy().copy(),
                      "same_keys": bool(torch.equal(binned, plain[0])), "r": r})
        return binned, sizes

    def exchange_kept(send, bin_sizes):
        received, runs = exchange(send, bin_sizes)
        steps[-1].update(runs=runs.numpy().copy(), received=received.numpy().copy())
        return received, runs

    for with_ns in (False, True):
        reads = _reads(genome, 600, 150, with_ns=with_ns)
        counter = dc.ShardedPrimedDeviceCounter(31, keys, device="cpu")
        if with_ns:
            dc.route, dist.all_to_all_bins = route_kept, exchange_kept
        for b in range(0, len(reads), 128):
            counter.update_batch(reads[b:b + 128][rank::world])
        dc.route, dist.all_to_all_bins = route, exchange
        out[f"batch_{with_ns}"] = counter.to_host_arrays()
        out["partition"] = (counter.table.keys.numpy().view(np.uint64), counter._per_dev)
    out["route_steps"] = steps

    # the stream driver: this rank's reads of variable length, in blocks
    # of a few hundred bases
    _, vkeys, vreads = _variable_reads(17, 3)
    mine = vreads[rank::world]
    data = np.concatenate(mine) if mine else np.zeros(0, np.uint8)
    offsets = np.concatenate([[0], np.cumsum([len(r) for r in mine])]).astype(np.int64)
    counter = dc.count_stream_sharded([(LUT[data], offsets)], 17, vkeys, block_bases=512,
                                      device="cpu")
    out["stream"] = counter.to_host_arrays()

    # the file driver, the table given and built from the corpus
    reads_fa, corpus = os.path.join(workdir, "reads.fa"), os.path.join(workdir, "corpus.fa")
    fkeys = np.load(os.path.join(workdir, "keys.npy"))
    given = dc.count_file_primed_sharded(reads_fa, 31, fkeys, block_bases=4096, device="cpu")
    built = dc.count_file_primed_sharded(reads_fa, 31, None, block_bases=4096,
                                         corpus_files=[corpus], device="cpu")
    out["file"] = [(c.keys, c.counts) for c in (given, built)]

    # _read_counter's routes, the cards' memory patched by table_fits
    routes = {}
    taken = []
    for name in ("count_file_primed_device", "count_file_primed_sharded"):
        fn = getattr(dc, name)

        def wrapped(*a, fn=fn, name=name, **kw):
            taken.append(name)
            return fn(*a, **kw)
        setattr(dc, name, wrapped)
    os.environ["PANGENIE_TORCH_COUNTER"] = "device"
    # without keys the corpus's size bounds the table's
    share = -(-max(len(fkeys), os.path.getsize(corpus)) // world)
    for route, limit in (("whole", 1 << 40), ("partitioned", share), ("host", 0)):
        if route == "partitioned" and world == 1:
            continue
        dc.table_fits = lambda n, device, block, limit=limit: n <= limit
        for prime in (fkeys, None):
            taken.clear()
            c = commands._read_counter(reads_fa, corpus, 31, True, prime_keys=prime,
                                       device=torch.device("cpu"))
            routes[(route, prime is None)] = (c.keys, c.counts, list(taken))
    out["routes"] = routes

    # COUNT mode, the same [B, L] batch on every rank
    creads = _reads(_genome_and_keys(21, 20_000, seed=5)[0], 101, 60, seed=6, with_ns=True)
    keys_g, counts_g = dc.sharded_count_kmers(creads, 21, device="cpu")
    keys_p, counts_p = dc.sharded_count_kmers_partitioned(creads, 21, device="cpu")
    out["count_mode"] = (keys_g.numpy(), counts_g.numpy(), keys_p.numpy(), counts_p.numpy())
    return out


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A read FASTA, its graph corpus and the corpus's keys; the host
    engine's counts of it."""
    d = tmp_path_factory.mktemp("sharded_counter")
    rng = np.random.default_rng(21)
    genome = rng.integers(0, 4, size=60_000).astype(np.uint8)
    with open(d / "corpus.fa", "w") as f:
        f.write(f">seg\n{LUT[genome].tobytes().decode()}\n")
    _write_fasta(d / "reads.fa", _texts(_reads(genome, 300, 120, seed=22, with_ns=True)))
    keys = np.unique(ExactKmerCounter._extract_canonical([LUT[genome].tobytes()], 31))
    np.save(d / "keys.npy", keys)
    host = ExactKmerCounter.count_file_primed(str(d / "reads.fa"), [str(d / "corpus.fa")], 31,
                                              keys=keys)
    return d, keys, host


@pytest.fixture(scope="module")
def ranks(files, tmp_path_factory):
    """What every rank gave, by world size (one spawned run a world)."""
    from concurrent.futures import ThreadPoolExecutor

    d = files[0]
    with ThreadPoolExecutor(len(WORLDS)) as pool:
        runs = {w: pool.submit(run_ranks, tmp_path_factory.mktemp(f"world{w}"), w,
                               "test_torch_sharded_counter:counter_rank", (str(d),))
                for w in WORLDS}
        return {w: run.result() for w, run in runs.items()}


def _jax_mesh(world):
    import jax

    if jax.device_count() < world:
        pytest.skip(f"needs {world} (virtual) devices")
    return jax.sharding.Mesh(np.array(jax.devices()[:world]), ("d",))


@pytest.mark.parametrize("with_ns", [False, True])
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_matches_reference_and_host(ranks, world, with_ns):
    from pangenie_tpu.kmers.device_counter import ShardedPrimedDeviceCounter

    genome, keys = _genome_and_keys(31, 200_000)
    reads = _reads(genome, 600, 150, with_ns=with_ns)
    want = _host_counts(31, keys, _texts(reads))
    ref = ShardedPrimedDeviceCounter(_jax_mesh(world), 31, keys, buffer_capacity=1 << 17)
    for b in range(0, len(reads), 128):
        ref.update_batch(reads[b:b + 128])
    ref_keys, ref_counts = ref.to_host_arrays()
    np.testing.assert_array_equal(ref_counts, want)
    for r in ranks[world]:
        got_keys, got = r[f"batch_{with_ns}"]
        np.testing.assert_array_equal(got_keys, ref_keys)
        np.testing.assert_array_equal(got, ref_counts)


@pytest.mark.parametrize("world", WORLDS)
def test_route_sizes_sent_and_received(ranks, world, monkeypatch):
    """Each ingest step's per-bin sizes sent are route_plain's on the
    same keys (and so are the binned keys); what each rank receives from
    each sender is that sender's row of bins for it, region by region,
    and every key received in a region's run is of this owner and
    region."""
    from pangenie_tpu_torch.kmers import device_counter as dc
    import torch

    _, keys = _genome_and_keys(31, 200_000)
    monkeypatch.setattr(dc, "REGION_SHIFT", 14)   # as the ranks took it
    by_rank = {r["rank"]: r["route_steps"] for r in ranks[world]}
    n_steps = len(by_rank[0])
    assert n_steps == 5 and all(len(s) == n_steps for s in by_rank.values())
    for i in range(n_steps):
        for t in range(world):
            step = by_rank[t][i]
            r = step["r"]
            assert r == dc.region_bits(len(keys) // world, world, 31) > 0
            assert step["same_keys"]
            np.testing.assert_array_equal(step["sent"], step["plain"])
            assert step["sent"].shape == (world, 1 << r)
            want_runs = np.stack([by_rank[s][i]["sent"][t] for s in range(world)])
            np.testing.assert_array_equal(step["runs"], want_runs)
            received = torch.from_numpy(step["received"])
            assert len(received) == want_runs.sum() > 0
            bins = dc.route_bins(received, 31, world, r).numpy()
            at = 0
            for s in range(world):
                for g in range(1 << r):
                    n = int(step["runs"][s, g])
                    assert (bins[at:at + n] == (t << r) | g).all()
                    at += n


@pytest.mark.parametrize("world", WORLDS)
def test_partitions_are_the_references(ranks, world):
    """Each rank's partition is the reference's device partition, and
    the partitions are balanced (max/min within 20%, as the reference
    asks of 8)."""
    from pangenie_tpu.kmers.device_counter import ShardedPrimedDeviceCounter

    _, keys = _genome_and_keys(31, 200_000)
    ref = ShardedPrimedDeviceCounter(_jax_mesh(world), 31, keys, buffer_capacity=1 << 17)
    assert ref._per_dev.max() < 1.2 * ref._per_dev.min()
    starts = np.concatenate([[0], np.cumsum(ref._per_dev)])
    for r in ranks[world]:
        part, per_dev = r["partition"]
        np.testing.assert_array_equal(per_dev, ref._per_dev)
        rank = r["rank"]
        np.testing.assert_array_equal(part, keys[ref._order[starts[rank]:starts[rank + 1]]])


@pytest.mark.parametrize("world", WORLDS)
def test_stream_driver_chunks_variable_reads(ranks, world):
    """Reads of 17-399 bases over the ranks, in blocks of 512 bases: every
    window once, none across reads; the reference's stream driver on the
    same reads gives the same counts."""
    from pangenie_tpu.kmers.device_counter import count_stream_sharded

    _, keys, reads = _variable_reads(17, 3)
    want = _host_counts(17, keys, [LUT[r].tobytes() for r in reads])
    data = np.concatenate(reads)
    offsets = np.concatenate([[0], np.cumsum([len(r) for r in reads])]).astype(np.int64)
    ref = count_stream_sharded(_jax_mesh(world), [(LUT[data], offsets)], 17, keys,
                               chunk=256, batch_rows=64, buffer_capacity=1 << 17)
    np.testing.assert_array_equal(ref.to_host_arrays()[1], want)
    for r in ranks[world]:
        got_keys, got = r["stream"]
        np.testing.assert_array_equal(got_keys, keys)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("world", WORLDS)
def test_count_file_primed_sharded(files, ranks, world):
    """A FASTA through the file driver, the table given and built on the
    ranks from the corpus: the host engine's keys and counts (zero counts
    kept), and the reference's file driver's."""
    from pangenie_tpu.kmers.device_counter import count_file_primed_sharded

    d, keys, host = files
    ref = count_file_primed_sharded(str(d / "reads.fa"), 31, keys, mesh=_jax_mesh(world))
    np.testing.assert_array_equal(ref.counts, host.counts)
    for r in ranks[world]:
        for got_keys, got in r["file"]:
            np.testing.assert_array_equal(got_keys, host.keys)
            np.testing.assert_array_equal(got, host.counts)


@pytest.mark.parametrize("world, route", [
    (w, r) for w in WORLDS for r in ("whole", "partitioned", "host")
    if not (w == 1 and r == "partitioned")])  # one rank has no partitions
def test_read_counter_routes(files, ranks, world, route):
    """``_read_counter`` under PANGENIE_TORCH_COUNTER=device with the
    cards' memory patched: D1 against the whole table where it fits, the
    partitioned counter where only a world's share fits, else the host
    engine; every route, the table given or built, the host engine's
    counts of every read."""
    _, _, host = files
    expect = {"whole": ["count_file_primed_device"],
              "partitioned": ["count_file_primed_sharded"], "host": []}[route]
    for r in ranks[world]:
        for built in (False, True):
            keys, counts, taken = r["routes"][(route, built)]
            assert taken == expect
            np.testing.assert_array_equal(keys, host.keys)
            np.testing.assert_array_equal(counts, host.counts)


@pytest.mark.parametrize("world", [2, 3])
def test_count_mode_matches_reference(ranks, world):
    """COUNT mode: the gathered table equals the reference's
    ``sharded_count_kmers`` (its mask applied) on every rank, and each
    rank's partition the reference's ``sharded_count_kmers_partitioned``
    device partition (one rank's is the one-device COUNT counter,
    tests/test_torch_device_counter.py)."""
    from pangenie_tpu.kmers import device_counter as ref_dc

    creads = _reads(_genome_and_keys(21, 20_000, seed=5)[0], 101, 60, seed=6, with_ns=True)
    mesh = _jax_mesh(world)
    hi, lo, cnt, mask = (np.asarray(x) for x in ref_dc.sharded_count_kmers(mesh, creads, 21))
    keep = mask.astype(bool)
    ref_keys = (hi[keep].astype(np.int64) << 32) | lo[keep].astype(np.int64)
    phi, plo, pcnt, pmask, overflow = ref_dc.sharded_count_kmers_partitioned(mesh, creads, 21)
    assert overflow == 0
    phi, plo, pcnt, pmask = (np.asarray(x).reshape(world, -1) for x in (phi, plo, pcnt, pmask))
    for r in ranks[world]:
        keys_g, counts_g, keys_p, counts_p = r["count_mode"]
        np.testing.assert_array_equal(keys_g, ref_keys)
        np.testing.assert_array_equal(counts_g, cnt[keep])
        row = pmask[r["rank"]].astype(bool)
        np.testing.assert_array_equal(
            keys_p, (phi[r["rank"]][row].astype(np.int64) << 32) | plo[r["rank"]][row])
        np.testing.assert_array_equal(counts_p, pcnt[r["rank"]][row])
    assert sum(len(r["count_mode"][2]) for r in ranks[world]) == len(ref_keys)
