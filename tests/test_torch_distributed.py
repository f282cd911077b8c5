"""The port's multi-process layer (``pangenie_tpu_torch/parallel/distributed.py``)
on gloo process groups of spawned CPU processes.

Each group joins through a ``file://`` store in the test's own
``tmp_path`` (no TCP port, so parallel test workers cannot collide),
from the variables a user sets (PANGENIE_TPU_COORDINATOR,
PANGENIE_TPU_NUM_PROCESSES, PANGENIE_TPU_PROCESS_ID), and every spawned
run has a timeout. The end-to-end test runs ``index`` and ``genotype -f
-a -g -p`` at 2 and 3 ranks on a panel of three chromosomes with several
path subsets, so that partial results are merged across ranks: the
coordinator's VCF bodies must equal the one-process port's, and the
other ranks write no output file. ``run_ranks`` is the harness the
other ``test_torch_*`` files of the multi-process layer use.
"""

import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.dirname(os.path.abspath(__file__))

CHILD = textwrap.dedent("""
    import importlib, pickle, sys
    sys.path[:0] = [sys.argv[1], sys.argv[2]]
    import torch
    torch.set_num_threads(1)
    from pangenie_tpu_torch.parallel import distributed as dist
    dist.maybe_initialize()
    module, name = sys.argv[3].split(":")
    with open(sys.argv[4], "rb") as f:
        args = pickle.load(f)
    result = getattr(importlib.import_module(module), name)(*args)
    with open(sys.argv[5], "wb") as f:
        pickle.dump(result, f)
    dist.shutdown()
""")


def run_ranks(tmp_path, world, target, args=(), timeout=240, env=None, cwd=None):
    """Run ``target`` ("module:function", importable from tests/) in
    ``world`` spawned processes joined in a gloo group on the CPU; the
    list of what each rank's call returned, in rank order."""
    tmp = str(tmp_path)
    os.makedirs(tmp, exist_ok=True)
    store = os.path.join(tmp, f"store_{world}")
    if os.path.exists(store):
        os.remove(store)
    arg_file = os.path.join(tmp, f"args_{world}.pkl")
    with open(arg_file, "wb") as f:
        pickle.dump(tuple(args), f)
    procs = []
    for rank in range(world):
        child_env = dict(os.environ, PANGENIE_TORCH_DEVICE="cpu",
                         PANGENIE_TPU_COORDINATOR="file://" + store,
                         PANGENIE_TPU_NUM_PROCESSES=str(world),
                         PANGENIE_TPU_PROCESS_ID=str(rank), OMP_NUM_THREADS="1")
        child_env.update(env or {})
        out = os.path.join(tmp, f"result_{world}_{rank}.pkl")
        proc = subprocess.Popen(
            [sys.executable, "-c", CHILD, REPO, TESTS, target, arg_file, out],
            env=child_env, cwd=cwd or tmp, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        procs.append((proc, out))
    results = []
    try:
        for proc, out in procs:
            _, stderr = proc.communicate(timeout=timeout)
            assert proc.returncode == 0, stderr[-4000:]
            with open(out, "rb") as f:
                results.append(pickle.load(f))
    finally:
        for proc, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return results


def test_helpers_single_process():
    import torch

    from pangenie_tpu_torch.parallel import distributed as dist

    assert dist.layout() is None
    assert dist.process_count() == 1
    assert dist.is_coordinator()
    assert dist.partition(5) == [0, 1, 2, 3, 4]
    assert dist.owns(3)
    x = np.arange(7, dtype=np.int64)
    np.testing.assert_array_equal(dist.allreduce_sum(x), x)
    assert dist.gather_objects({"a": 1}) == [{"a": 1}]
    (hosted,) = dist.gather_to_host(torch.arange(3, dtype=torch.int32))
    np.testing.assert_array_equal(hosted, np.arange(3, dtype=np.int32))
    assert list(dist.shard_sequences("abcd", None)) == list("abcd")
    assert list(dist.shard_sequences("abcd", (1, 2))) == ["b", "d"]
    assert list(dist.shard_sequences("abcd", (0, 3))) == ["a", "d"]
    assert dist.maybe_initialize() is False  # no variables: no group
    assert dist.layout() is None


@pytest.mark.parametrize("peers, rank, want", [
    ([("a", 0), ("a", 0)], 1, ("gloo", 1, None)),         # the CPU
    ([("a", 1)], 0, ("nccl", 0, 0)),                      # one rank, one card
    ([("a", 2), ("a", 2), ("b", 1)], 1, ("nccl", 1, 1)),  # a card a rank
    ([("a", 1), ("a", 1)], 1, ("gloo", 1, 0)),            # two ranks share a card
    ([("a", 2), ("b", 0)], 0, ("gloo", 0, 0)),            # a rank without a card
], ids=["cpu", "one_card", "card_each", "shared_card", "mixed"])
def test_layout_follows_the_hosts(peers, rank, want):
    from pangenie_tpu_torch.parallel.distributed import choose_layout

    assert tuple(choose_layout(rank, peers)) == want


def collectives_rank(chunk):
    """Every helper once at this rank (allreduce_sum and gather_to_host
    across ``chunk``-sized chunks), with what each gave."""
    import torch

    from pangenie_tpu_torch.parallel import distributed as dist

    dist._CHUNK = chunk
    rank, world = dist.process_index(), dist.process_count()
    x = np.arange(23, dtype=np.int64) * (rank + 1)
    summed = dist.allreduce_sum(x.reshape(23, 1))
    gathered = dist.gather_objects({"rank": rank, "items": dist.partition(7)})
    dist.barrier()
    varying = dist.all_gather_varying(torch.arange(rank + 2, dtype=torch.int64))
    hosted = dist.gather_to_host(torch.arange(4 * rank + 3, dtype=torch.int32) + 100 * rank)
    send = torch.arange(world * 3, dtype=torch.int64) + 100 * rank
    sizes = torch.tensor([3] * world)
    routed = dist.all_to_all_exact(send, sizes)
    return dict(layout=tuple(dist.layout()), rank=rank, world=world, summed=summed,
                gathered=gathered, owns=[dist.owns(i) for i in range(7)],
                varying=[v.tolist() for v in varying], routed=routed.tolist(),
                hosted=[(h.dtype.name, h.tolist()) for h in hosted],
                any=dist.any_rank(rank == world - 1), none=dist.any_rank(False))


@pytest.mark.parametrize("world", [2, 3])
def test_collectives(tmp_path, world):
    results = run_ranks(tmp_path, world, "test_torch_distributed:collectives_rank", (5,))
    want = np.arange(23, dtype=np.int64).reshape(23, 1) * sum(range(1, world + 1))
    owners = [[] for _ in range(world)]
    for r in results:
        assert r["layout"] == ("gloo", r["rank"], None)
        assert r["world"] == world
        # 23 elements in chunks of 5 cross four chunk boundaries
        np.testing.assert_array_equal(r["summed"], want)
        assert r["varying"] == [list(range(q + 2)) for q in range(world)]
        # 3, 7 and 11 elements: a chunk, two and three of 5
        assert r["hosted"] == [("int32", list(range(100 * q, 100 * q + 4 * q + 3)))
                               for q in range(world)]
        assert r["routed"] == [100 * q + 3 * r["rank"] + i for q in range(world) for i in range(3)]
        assert r["any"] and not r["none"]
        for i, mine in enumerate(r["owns"]):
            if mine:
                owners[r["rank"]].append(i)
    assert results[0]["gathered"] == [{"rank": q, "items": list(range(q, 7, world))}
                                      for q in range(world)]
    assert all(r["gathered"] is None for r in results[1:])
    assert owners == [list(range(q, 7, world)) for q in range(world)]


def _build_inputs(d, rng):
    """Three chromosomes of 20 kb, 6 samples (13 paths with the
    reference), 20x reads of sample 0 (tests/test_local_shard.py's)."""
    from pangenie_tpu_torch.utils import simulate as sim

    chroms = {}
    with open(d / "ref.fa", "w") as fa, open(d / "panel.vcf", "w") as vcf:
        vcf.write("##fileformat=VCFv4.2\n")
        vcf.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                  + "\t".join(f"S{i}" for i in range(6)) + "\n")
        for name in ("chr1", "chr2", "chr3"):
            ref = sim.random_reference(20_000, rng)
            variants = sim.simulate_panel(ref, nr_samples=6, rng=rng)
            chroms[name] = (ref, variants)
            fa.write(f">{name}\n{ref.decode()}\n")
            for v in variants:
                gts = "\t".join(f"{a}|{b}" for a, b in v.genotypes)
                vcf.write(f"{name}\t{v.position + 1}\t.\t{v.ref.decode()}\t"
                          f"{','.join(x.decode() for x in v.alts)}\t.\tPASS\t.\t"
                          f"GT\t{gts}\n")
    reads = []
    for name, (ref, variants) in chroms.items():
        h1, h2 = sim.haplotype_sequences(ref, variants, 0)
        reads.extend(sim.simulate_reads(h1, h2, 20, 100, rng))
    with open(d / "reads.fa", "w") as out:
        for i, r in enumerate(reads):
            out.write(f">r{i}\n{r.decode()}\n")


GENOTYPE = ["-a", "5", "-g", "-p"]


def genotype_rank(panel_dir, outname):
    """``genotype -f -a 5 -g -p`` through the CLI at this rank, from a
    directory of its own; the files this rank wrote there."""
    from pangenie_tpu_torch import cli
    from pangenie_tpu_torch.parallel import distributed as dist

    own = os.path.abspath(f"rank{dist.process_index()}")
    os.makedirs(own)
    os.chdir(own)
    assert cli.main(["genotype", "-i", os.path.join(panel_dir, "reads.fa"), "-f",
                     os.path.join(panel_dir, "idx"), *GENOTYPE, "-o", outname]) == 0
    return sorted(os.listdir(own))


def _body(path):
    with open(path) as f:
        return [line for line in f if not line.startswith("##")]


@pytest.fixture(scope="module")
def panel(tmp_path_factory):
    """The three-chromosome panel indexed by the port, and the
    one-process port's genotyping and phasing VCFs."""
    from pangenie_tpu_torch import cli
    from pangenie_tpu_torch.panel.sampling import reset_global_rand

    d = tmp_path_factory.mktemp("distributed_panel")
    _build_inputs(d, np.random.default_rng(17))
    cwd = os.getcwd()
    os.chdir(d)
    try:
        os.environ["PANGENIE_TORCH_DEVICE"] = "cpu"
        assert cli.main(["index", "-r", "ref.fa", "-v", "panel.vcf", "-o", "idx"]) == 0
        reset_global_rand()
        assert cli.main(["genotype", "-i", "reads.fa", "-f", "idx", *GENOTYPE,
                         "-o", "one"]) == 0
    finally:
        os.environ.pop("PANGENIE_TORCH_DEVICE", None)
        os.chdir(cwd)
    return d


@pytest.mark.parametrize("world", [2, 3])
def test_genotype_over_ranks_equals_one_process(panel, tmp_path, world):
    out = f"ranks{world}"
    written = run_ranks(tmp_path, world, "test_torch_distributed:genotype_rank",
                        (str(panel), out))
    assert written[0] == [f"{out}_{kind}" for kind in (
        "genotyping.vcf", "histogram.histo", "phasing.vcf")]
    assert written[1:] == [[]] * (world - 1)
    for kind in ("genotyping", "phasing"):
        one = _body(panel / f"one_{kind}.vcf")
        assert len(one) > 100
        assert _body(tmp_path / "rank0" / f"{out}_{kind}.vcf") == one, kind
