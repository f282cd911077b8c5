"""The port's device k-mer counter (``kmers/device_counter.py``, D1's
plain versions on the CPU) against the reference package's
``pangenie_tpu.kmers.device_counter`` (JAX on the CPU) and the host
engine, exactly: keys and counts are integers.

The first cases mirror tests/test_device_counter.py case for case for
the single-device functions (the sharded ones, over ranks, are
tests/test_torch_sharded_counter.py's); then the file counter on FASTA, FASTQ and gzipped input, with
the table given and built by the port, against both references; the
carry-across of the reference counter's state; and ``single``,
``genotype -f`` and ``sampling`` routed through D1
(PANGENIE_TORCH_COUNTER=device) against the reference package's
outputs.
"""

import gzip

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pangenie_tpu import commands as jax_commands
from pangenie_tpu.kmers import device_counter as ref_dc
from pangenie_tpu.panel.sampling import reset_global_rand as jax_reset_rand
from pangenie_tpu_torch import commands
from pangenie_tpu_torch.kmers import device_counter as dc
from pangenie_tpu_torch.kmers.counter import ExactKmerCounter, iter_sequences
from pangenie_tpu_torch.panel.sampling import reset_global_rand as torch_reset_rand
from pangenie_tpu_torch.utils import simulate as sim

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _random_reads(rng, n, length, with_ns=False):
    alphabet = [65, 67, 71, 84, 78] if with_ns else [65, 67, 71, 84]
    p = [0.235, 0.235, 0.235, 0.235, 0.06] if with_ns else None
    return [
        bytes(rng.choice(alphabet, length, p=p).astype(np.uint8))
        for _ in range(n)
    ]


# -- mirrored from tests/test_device_counter.py ------------------------------


@pytest.mark.parametrize("k", [5, 16, 21, 31])
def test_device_counts_match_host(k):
    rng = np.random.default_rng(k)
    reads = _random_reads(rng, 64, 80, with_ns=True)
    host = ExactKmerCounter.count_sequences(reads, k)

    dev = dc.DeviceKmerCounter(k, device="cpu")
    codes, _ = dc.pack_read_batch(reads)
    dev.add_batch(codes)
    keys, counts = dev.to_host_arrays()
    assert np.array_equal(keys, host.keys)
    assert np.array_equal(counts, host.counts)


def test_device_batched_merge_matches_host():
    rng = np.random.default_rng(9)
    reads = _random_reads(rng, 200, 60)
    host = ExactKmerCounter.count_sequences(reads, 31)

    dev = dc.DeviceKmerCounter(31, device="cpu")
    for i in range(0, len(reads), 64):  # uneven batches
        codes, _ = dc.pack_read_batch(reads[i : i + 64], length=60)
        dev.add_batch(codes)
    keys, counts = dev.to_host_arrays()
    assert np.array_equal(keys, host.keys)
    assert np.array_equal(counts, host.counts)


def test_device_counter_roundtrip_lookup():
    rng = np.random.default_rng(3)
    reads = _random_reads(rng, 32, 50)
    dev = dc.DeviceKmerCounter(21, device="cpu")
    codes, _ = dc.pack_read_batch(reads)
    dev.add_batch(codes)
    counter = dev.to_exact_counter()
    host = ExactKmerCounter.count_sequences(reads, 21)
    for read in reads[:5]:
        query = read[:21].decode()
        assert counter.get_kmer_abundance(query) == host.get_kmer_abundance(query)


def test_primed_device_counter_matches_host():
    """PRIME+UPDATE: only registered (graph) k-mers are counted, exactly
    matching the host primed counter."""
    rng = np.random.default_rng(11)
    graph_seqs = _random_reads(rng, 30, 90)
    reads = _random_reads(rng, 150, 70, with_ns=True)
    reads = [
        graph_seqs[i % len(graph_seqs)][:40] + r[40:]
        for i, r in enumerate(reads)
    ]
    k = 21
    host = ExactKmerCounter.count_sequences_primed(reads, graph_seqs, k)

    graph_keys = ExactKmerCounter.count_sequences(graph_seqs, k).keys
    dev = dc.PrimedDeviceCounter(k, graph_keys, device="cpu")
    for i in range(0, len(reads), 64):
        codes, _ = dc.pack_read_batch(reads[i : i + 64], length=70)
        dev.update_batch(codes)

    counter = dev.to_exact_counter()
    assert np.array_equal(counter.get_abundances(graph_keys), host.get_abundances(graph_keys))
    assert set(counter.keys).issubset(set(graph_keys))


def test_lookup_sorted_bounds():
    keys = torch.tensor([3, 9, 12, 700, 2**40 + 5], dtype=torch.int64)
    q = torch.tensor([0, 3, 10, 12, 2**40 + 5, 2**62], dtype=torch.int64)
    idx, found = dc.lookup(keys, q)
    assert found.tolist() == [False, True, False, True, True, False]
    assert idx[1] == 0 and idx[3] == 2 and idx[4] == 4
    # the reference's lookup_pair_sorted on the same keys
    def pair(x):
        x = x.numpy().astype(np.uint64)
        return (jnp.asarray((x >> np.uint64(32)).astype(np.uint32)),
                jnp.asarray((x & np.uint64(0xFFFFFFFF)).astype(np.uint32)))

    ref_idx, ref_found = ref_dc.lookup_pair_sorted(*pair(keys), *pair(q))
    assert np.array_equal(np.asarray(ref_found), found.numpy())
    assert np.array_equal(np.asarray(ref_idx)[found.numpy()], idx[found].numpy())
    empty, none = dc.lookup(keys[:0], q)
    assert not none.any() and empty.shape == q.shape


def test_pack_unpack_2bit_roundtrip():
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 5, size=(7, 53)).astype(np.uint8)  # incl. N=4
    words, vwords = dc.pack_codes_2bit(codes)
    ref_words, ref_vwords = ref_dc.pack_codes_2bit(codes)
    assert np.array_equal(words, ref_words) and np.array_equal(vwords, ref_vwords)
    back = dc.unpack_codes_2bit(words, vwords, codes.shape[1]).numpy()
    np.testing.assert_array_equal(back, codes)
    np.testing.assert_array_equal(
        back, np.asarray(ref_dc.unpack_codes_2bit(words, vwords, codes.shape[1])))


def test_primed_merge_matches_host_counts():
    k = 21
    rng = np.random.default_rng(11)
    genome = rng.integers(0, 4, size=4000).astype(np.uint8)
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    graph_keys = np.unique(
        ExactKmerCounter._extract_canonical([lut[genome].tobytes()], k)
    )
    starts = rng.integers(0, len(genome) - 60, size=300)
    reads = genome[starts[:, None] + np.arange(60)[None, :]].copy()
    reads[rng.integers(0, 300, 40), rng.integers(0, 60, 40)] = 4

    read_kmers = ExactKmerCounter._extract_canonical(
        [bytes(lut[c] if c <= 3 else b"N"[0] for c in r) for r in reads], k
    )
    uniq, cnt = np.unique(read_kmers, return_counts=True)
    expected = np.zeros(len(graph_keys), np.int64)
    pos = np.searchsorted(graph_keys, uniq)
    ok = (pos < len(graph_keys))
    ok &= graph_keys[np.minimum(pos, len(graph_keys) - 1)] == uniq
    expected[pos[ok]] = cnt[ok]

    dev = dc.PrimedDeviceCounter(k, graph_keys, device="cpu")
    dev.update_batch(reads[:128])
    words, vwords = dc.pack_codes_2bit(reads[128:])
    dev.update_packed_batch(words, vwords, reads.shape[1])
    keys, counts = dev.to_host_arrays()
    np.testing.assert_array_equal(keys, graph_keys)
    np.testing.assert_array_equal(counts, expected)


def _genome_files(tmp_path, rng, odd=True):
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    genome = bases[rng.integers(0, 4, size=6000)].tobytes()
    corpus = tmp_path / "segments.fa"
    corpus.write_text(f">seg\n{genome.decode()}\n")
    reads = []
    for _ in range(300):
        start = int(rng.integers(0, len(genome) - 100))
        reads.append(genome[start:start + int(rng.integers(40, 100))])
    if odd:
        reads.append(b"ACGTNNACGTACGTACGTACGTACGTACGTACGTACG")
        reads.append(b"ACGTA")  # shorter than k
    return corpus, reads


def _write_reads(path, reads, fmt):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wt") as out:
        for i, r in enumerate(reads):
            if fmt == "fastq":
                out.write(f"@r{i}\n{r.decode()}\n+\n{'I' * len(r)}\n")
            else:
                out.write(f">r{i}\n{r.decode()}\n")


def test_count_file_primed_device_matches_host(tmp_path):
    """The file counter (file in, ExactKmerCounter out) gives the host
    primed counter's table exactly (keys AND counts, zero-count graph
    keys included), with small blocks: many launches."""
    corpus, reads = _genome_files(tmp_path, np.random.default_rng(11))
    path = str(tmp_path / "reads.fa")
    _write_reads(path, reads, "fasta")
    k = 31
    host = ExactKmerCounter.count_file_primed(path, [str(corpus)], k)
    dev = dc.count_file_primed_device(path, [str(corpus)], k, block_bases=4096, device="cpu")
    np.testing.assert_array_equal(host.keys, dev.keys)
    np.testing.assert_array_equal(host.counts, dev.counts)
    assert (dev.counts == 0).any() and (dev.counts > 0).any()


def test_counter_routing(monkeypatch):
    """PANGENIE_TORCH_COUNTER forces either route on any device;
    otherwise D1 on the card only."""
    monkeypatch.delenv("PANGENIE_TORCH_COUNTER", raising=False)
    assert not commands._device_counter(CPU)
    assert commands._device_counter(torch.device("cuda"))
    monkeypatch.setenv("PANGENIE_TORCH_COUNTER", "host")
    assert not commands._device_counter(torch.device("cuda"))
    monkeypatch.setenv("PANGENIE_TORCH_COUNTER", "device")
    assert commands._device_counter(CPU)
    monkeypatch.setenv("PANGENIE_TORCH_COUNTER", "tpu")
    with pytest.raises(RuntimeError, match="PANGENIE_TORCH_COUNTER"):
        commands._device_counter(CPU)


def test_prime_from_corpus_builds_device_table(tmp_path):
    """The table built on the device equals the host's key set exactly:
    N-containing sequences, a sequence longer than one round (cut into
    overlapping rows) and rounds smaller than the corpus's windows, so
    the held table folds several times."""
    rng = np.random.default_rng(5)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    k = 31
    genome = bases[rng.integers(0, 4, size=20000)].tobytes()
    seqs = [genome + genome[100:] + genome[257:] + genome[1033:9000]]
    withn = bytearray(bases[rng.integers(0, 4, size=500)].tobytes())
    withn[100:105] = b"NNNNN"
    seqs += [bytes(withn), b"ACG"]
    corpus = tmp_path / "corpus.fa"
    with open(corpus, "w") as out:
        for i, s in enumerate(seqs):
            out.write(f">s{i}\n{s.decode()}\n")
    keys = np.unique(
        ExactKmerCounter._extract_canonical(iter_sequences(str(corpus)), k)
    )
    calls = []
    real_extract = dc.extract

    def spy(*args, **kwargs):
        calls.append(args[2])
        return real_extract(*args, **kwargs)

    dc.extract = spy
    try:
        counter = dc.PrimedDeviceCounter(k, None, corpus_files=[str(corpus)], device="cpu",
                                         round_windows=1 << 15)
    finally:
        dc.extract = real_extract
    assert counter.primed_on_device and len(calls) >= 3
    np.testing.assert_array_equal(counter.table.keys.numpy().view(np.uint64), keys)
    # the directory bounds every bucket of the table
    d = counter.table.directory.long()
    buckets = counter.table.keys >> counter.table.shift
    assert torch.equal(d[buckets] <= torch.arange(len(keys)), torch.ones(len(keys), dtype=torch.bool))
    assert torch.equal(torch.arange(len(keys)) < d[buckets + 1], torch.ones(len(keys), dtype=torch.bool))


def test_ultralong_read_exceeding_one_block(tmp_path):
    """A read whose windows exceed a block is cut into rows that overlap
    by k - 1 and counted exactly."""
    rng = np.random.default_rng(3)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    k = 31
    genome = bases[rng.integers(0, 4, size=3000)].tobytes()
    longread = (genome * 40)[:100_000]
    corpus = tmp_path / "c.fa"
    reads = tmp_path / "r.fa"
    corpus.write_text(f">s\n{genome.decode()}\n")
    reads.write_text(f">L\n{longread.decode()}\n>tiny\n{genome[:80].decode()}\n")
    host = ExactKmerCounter.count_file_primed(str(reads), [str(corpus)], k)
    dev = dc.count_file_primed_device(str(reads), [str(corpus)], k, block_bases=1 << 14,
                                      device="cpu")
    np.testing.assert_array_equal(host.keys, dev.keys)
    np.testing.assert_array_equal(host.counts, dev.counts)
    assert dev.counts.max() >= 30


# -- beyond the mirrored cases ----------------------------------------------


@pytest.mark.parametrize("fmt", ["fasta", "fastq", "fasta.gz", "fastq.gz"])
@pytest.mark.parametrize("given", [False, True], ids=["table_built", "keys_given"])
def test_count_file_matches_both_references(tmp_path, fmt, given):
    """FASTA, FASTQ and gzipped input, the table built on the device or
    the keys given: keys and counts equal the reference's device counter
    (JAX on the CPU) and the host engine's; a read longer than one block
    among them."""
    rng = np.random.default_rng(23)
    corpus, reads = _genome_files(tmp_path, rng)
    reads.append(reads[0] * 3 + reads[1] * 2)  # over a 256-base block
    path = str(tmp_path / f"reads.{fmt}")
    _write_reads(path, reads, fmt.split(".")[0])
    k = 31
    host = ExactKmerCounter.count_file_primed(path, [str(corpus)], k)
    keys = host.keys if given else None
    ref = ref_dc.count_file_primed_device(path, [str(corpus)], k, block_bases=4096, keys=keys)
    dev = dc.count_file_primed_device(path, [str(corpus)], k, block_bases=256, keys=keys,
                                      device="cpu")
    for other in (host, ref):
        np.testing.assert_array_equal(dev.keys, other.keys)
        np.testing.assert_array_equal(dev.counts, other.counts)


def test_shards_sum_to_the_whole(tmp_path):
    """``shard=(i, n)`` counts every n-th read; the shards' counts sum to
    the whole file's."""
    corpus, reads = _genome_files(tmp_path, np.random.default_rng(29))
    path = str(tmp_path / "reads.fa")
    _write_reads(path, reads, "fasta")
    whole = dc.count_file_primed_device(path, [str(corpus)], 21, device="cpu")
    parts = [dc.count_file_primed_device(path, [str(corpus)], 21, shard=(i, 3), device="cpu")
             for i in range(3)]
    assert all(np.array_equal(p.keys, whole.keys) for p in parts)
    assert np.array_equal(sum(p.counts for p in parts), whole.counts)
    assert all(p.counts.sum() < whole.counts.sum() for p in parts)


@pytest.mark.parametrize("k", [1, 5, 11, 31])
def test_extract_canonical_matches_reference(k):
    """The [B, W] keys and validity of a code batch with N's equal the
    reference's (hi, lo, valid)."""
    rng = np.random.default_rng(40 + k)
    codes, _ = ref_dc.pack_read_batch(_random_reads(rng, 9, 47, with_ns=True))
    keys, valid = dc.extract_canonical(codes, k, device="cpu")
    hi, lo, ref_valid = (np.asarray(x) for x in ref_dc.extract_canonical(codes, k))
    ref_keys = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    assert np.array_equal(valid.numpy(), ref_valid)
    assert np.array_equal(keys.numpy().view(np.uint64)[ref_valid], ref_keys[ref_valid])
    assert (keys[~valid] == dc.SENTINEL).all()


def test_count_merge_and_histogram_match_reference():
    """count_kmers, merge_tables and histogram against the reference's on
    the same keys (its tables carry a mask at sorted positions)."""
    rng = np.random.default_rng(8)
    codes_a, _ = ref_dc.pack_read_batch(_random_reads(rng, 40, 30))
    codes_b, _ = ref_dc.pack_read_batch(_random_reads(rng, 30, 30))
    k = 5
    tables = [dc.count_kmers(*dc.extract_canonical(c, k, device="cpu")) for c in (codes_a, codes_b)]
    keys, counts = dc.merge_tables(*tables[0], *tables[1])
    ref = [ref_dc.count_kmers(*ref_dc.extract_canonical(c, k)) for c in (codes_a, codes_b)]
    hi, lo, cnt, mask = (np.asarray(x) for x in ref_dc.merge_tables(*ref[0], *ref[1]))
    mask = mask.astype(bool)
    ref_keys = (hi[mask].astype(np.uint64) << np.uint64(32)) | lo[mask].astype(np.uint64)
    assert np.array_equal(keys.numpy().view(np.uint64), ref_keys)
    assert np.array_equal(counts.numpy(), cnt[mask])
    ref_hist = np.asarray(ref_dc.histogram(cnt, mask, 7))
    assert np.array_equal(dc.histogram(counts, 7).numpy(), ref_hist)
    assert np.array_equal(dc.histogram(torch.from_numpy(cnt.astype(np.int64)), 7,
                                       torch.from_numpy(mask)).numpy(), ref_hist)


def test_reference_state_carries_across():
    """The reference PrimedDeviceCounter's state after some batches, as
    numpy, becomes the port's; both then take the same batches and hold
    the same table."""
    rng = np.random.default_rng(17)
    k = 21
    graph = _random_reads(rng, 20, 120)
    keys = ExactKmerCounter.count_sequences(graph, k).keys
    reads = [g[s:s + 60] for g in graph for s in (0, 30, 55)]
    reads = [r[:20] + b"N" + r[21:] if i % 7 == 0 else r for i, r in enumerate(reads)]
    codes, _ = ref_dc.pack_read_batch(reads, length=60)
    ref = ref_dc.PrimedDeviceCounter(k, keys)
    ref.update_batch(codes[:25])
    ref._flush()
    port = dc.PrimedDeviceCounter.from_reference_state(
        k, np.asarray(ref._hi), np.asarray(ref._lo), np.asarray(ref._counts), device="cpu")
    assert port.counts.sum() > 0
    ref.update_batch(codes[25:])
    port.update_batch(codes[25:])
    ref_keys, ref_counts = ref.to_host_arrays()
    got_keys, got_counts = port.to_host_arrays()
    np.testing.assert_array_equal(got_keys, ref_keys)
    np.testing.assert_array_equal(got_counts, ref_counts)


def test_table_too_large_for_the_card_counts_on_the_host(tmp_path, monkeypatch, capsys):
    """Where D1's footprint exceeds the card, the route counts on the
    host engine (the same table)."""
    corpus, reads = _genome_files(tmp_path, np.random.default_rng(31))
    path = str(tmp_path / "reads.fa")
    _write_reads(path, reads, "fasta")
    assert dc.footprint_bytes(10, 100, 1 << 20) < dc.footprint_bytes(11, 100, 1 << 20)
    assert dc.table_fits(1 << 40, CPU, 1 << 20)
    monkeypatch.setenv("PANGENIE_TORCH_COUNTER", "device")
    monkeypatch.setattr(dc, "table_fits", lambda n, device, block: False)
    got = commands._read_counter(path, str(corpus), 31, True, device=CPU)
    assert "exceeds the card's memory" in capsys.readouterr().err
    want = ExactKmerCounter.count_file_primed(path, [str(corpus)], 31)
    assert np.array_equal(got.keys, want.keys) and np.array_equal(got.counts, want.counts)


# -- the commands through D1 -------------------------------------------------


@pytest.fixture(autouse=True)
def fresh_rand_streams():
    """Both packages' process-wide rand() streams from seed 1 (path
    subsets and sampling draw from them)."""
    jax_reset_rand()
    torch_reset_rand()


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    """A 40 kb chromosome, 8 samples (17 paths), 20x reads of sample 0,
    indexed by both packages."""
    d = tmp_path_factory.mktemp("d1_commands")
    rng = np.random.default_rng(4321)
    reference = sim.random_reference(40_000, rng)
    variants = sim.simulate_panel(reference, nr_samples=8, rng=rng)
    sim.write_inputs(str(d), reference, variants)
    hap1, hap2 = sim.haplotype_sequences(reference, variants, sample=0)
    sim.simulate_reads(hap1, hap2, coverage=20, read_length=100, rng=rng,
                       outfile=str(d / "reads.fa"))
    inputs = (str(d / "ref.fa"), str(d / "panel.vcf"), 31)
    assert jax_commands.run_index_command(*inputs, str(d / "jax_index")) == 0
    assert commands.run_index_command(*inputs, str(d / "torch_index")) == 0
    return d


def _body(path):
    with open(path) as f:
        return [line for line in f if not line.startswith("##")]


def _read(path):
    with open(path) as f:
        return f.read()


@pytest.mark.parametrize("command", ["single", "genotype_f", "sampling"])
def test_commands_through_d1_match_reference(workload, tmp_path, monkeypatch, capsys,
                                             command):
    """With PANGENIE_TORCH_COUNTER=device the port counts read k-mers
    through D1 (its plain versions; ``genotype -f`` and ``sampling`` build
    the table themselves, ``single`` passes its graph table), and writes
    the reference package's VCF bodies, histogram and paths TSVs."""
    d = str(workload)
    monkeypatch.setenv("PANGENIE_TORCH_COUNTER", "device")
    reads = f"{d}/reads.fa"
    jax_out, torch_out = str(tmp_path / "jax"), str(tmp_path / "torch")
    if command == "single":
        inputs = (reads, f"{d}/ref.fa", f"{d}/panel.vcf", 31)
        assert jax_commands.run_single_command(*inputs, jax_out) == 0
        assert commands.run_single_command(*inputs, torch_out, device="cpu") == 0
        outputs = ["_genotyping.vcf"]
    elif command == "genotype_f":
        assert jax_commands.run_genotype_command(f"{d}/jax_index", reads, jax_out,
                                                 panel_size=6, output_panel=True) == 0
        assert commands.run_genotype_command(f"{d}/torch_index", reads, torch_out,
                                             panel_size=6, output_panel=True,
                                             device="cpu") == 0
        outputs = ["_genotyping.vcf", "_panel.vcf", "_paths_chr1.tsv"]
    else:
        assert jax_commands.run_sampling(f"{d}/jax_index", reads, jax_out, panel_size=3) == 0
        assert commands.run_sampling(f"{d}/torch_index", reads, torch_out, panel_size=3,
                                     device="cpu") == 0
        outputs = ["_panel.vcf", "_paths_chr1.tsv"]
    err = capsys.readouterr().err
    assert "using device PRIME+UPDATE counter (D1) on cpu" in err
    assert f"(on_device={command != 'single'})" in err
    for suffix in outputs:
        want = _body(jax_out + suffix)
        assert len(want) > 5
        assert _body(torch_out + suffix) == want, suffix
    assert _read(torch_out + "_histogram.histo") == _read(jax_out + "_histogram.histo")
