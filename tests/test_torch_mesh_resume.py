"""A waterfall checkpoint shared by the ranks, decoders split over ranks, and
the port's dry run, on the CPU.

One module fixture starts two rank processes over Gloo once (as
tests/test_torch_parallel.py does) and runs every two-rank case in them, and
beside them `python -m labrador_ldpc_tpu_torch.entry 2`. A checkpoint is
written by rank 0 alone; rank 0 reads it on resume and sends what it read to
every rank with one `broadcast_object`. Every rank draws the whole global
batch and keeps its rows, so a sweep's counters do not depend on the ranks:
a sweep cut and resumed, on two ranks or on one, must give the counters of
the uninterrupted one-rank sweep, and a two-rank file must hold the lines of
a one-rank file. The sharded bit-flip decoder must equal the JAX
`shard_map_decoder(..., result_type=BFResult)` on the 8-device CPU mesh (the
port's plain QC decoder is bit-exact to the JAX one,
tests/test_torch_bitflip.py). Tolerance: exact everywhere.
"""

import collections
import dataclasses
import json
import os
import re
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from labrador_ldpc_tpu.channel.awgn import shard_map_decoder as jshard_map_decoder
from labrador_ldpc_tpu.ops.bitflip import BFResult as JBFResult
from labrador_ldpc_tpu.ops.bitflip import make_bf_decoder_qc as jmake_bf_decoder_qc
from labrador_ldpc_tpu.parallel import make_batch_mesh as jmake_batch_mesh

import labrador_ldpc_tpu_torch as T
from labrador_ldpc_tpu_torch.channel import awgn
from labrador_ldpc_tpu_torch.channel.awgn import _make_decoder, quantize_llrs
from labrador_ldpc_tpu_torch.channel.hard import _make_bf_decoder
from labrador_ldpc_tpu_torch.channel.waterfall import waterfall
from labrador_ldpc_tpu_torch.ops.bitflip import BFResult
from labrador_ldpc_tpu_torch.parallel import broadcast_object, make_batch_mesh, shard_decoder
from labrador_ldpc_tpu_torch.parallel.launch import free_port, run_processes

REPO = Path(__file__).resolve().parent.parent
FIELDS = [f.name for f in dataclasses.fields(T.SnrPoint) if f.name != "elapsed_s"]

# the checkpointed sweeps, three drained batches a point, and the lines of
# the file kept at the cut: "ms" inside its second point (the config, the
# first point's three batches and its done line, one batch), "bf" after one
# drained batch
SWEEPS = {
    "ms": dict(code="TC128", snrs_db=[2.0, 2.5], batch=32, maxiters=20, max_bits=32 * 64 * 3,
               max_bit_errors=10**9, seed=5, pipeline_depth=2),
    "bf": dict(code="TM1280", snrs_db=[0.02], batch=32, maxiters=10, max_bits=32 * 1024 * 3,
               max_bit_errors=10**9, seed=6, pipeline_depth=2, noise_model="bsc", decoder="bf"),
}
KEEP = {"ms": 6, "bf": 2}
RESUMED_BATCHES = {"ms": 2, "bf": 2}  # the batches a resumed sweep runs
# the decoders split with shard_decoder: (code, dtype, impl, maxiters); "bf"
# is the bit-flip decoder of impl (cuda: the kernel of ops/cuda_bf.py)
DECODERS = [("TM2048", "float32", "sp_layered", 8), ("TM1280", "int8", "cuda_layered", 8),
            ("TM1280", "bfloat16", "cuda_qc", 8), ("TM1280", "bf", "cuda", 8)]
BF_ITERS = 10  # the sharded bit-flip decoder held to the JAX one

RANK_PROGRAM = textwrap.dedent("""
    import dataclasses, json, pathlib, shutil, sys
    import numpy as np, torch
    torch.set_num_threads(1)
    import torch.distributed as dist
    from labrador_ldpc_tpu_torch.channel.awgn import _make_decoder
    from labrador_ldpc_tpu_torch.channel.hard import _make_bf_decoder
    from labrador_ldpc_tpu_torch.channel.waterfall import waterfall
    from labrador_ldpc_tpu_torch.parallel import (
        make_batch_mesh, make_sharded_bf_decoder, shard_decoder)
    from labrador_ldpc_tpu_torch.parallel.launch import initialize
    rank, port, work = int(sys.argv[1]), int(sys.argv[2]), pathlib.Path(sys.argv[3])
    spec = json.loads((work / "spec.json").read_text())
    initialize(f"127.0.0.1:{port}", 2, rank, device="cpu")
    mesh = make_batch_mesh(device="cpu")
    cpu = torch.device("cpu")

    calls = {"broadcast_object_list": 0, "all_reduce": 0}
    def counted(name):
        fn = getattr(dist, name)
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        setattr(dist, name, wrapper)
    for name in calls:
        counted(name)
    opened = []  # the files this rank opens
    path_open = pathlib.Path.open
    def open_spy(self, *args, **kwargs):
        opened.append(self.name)
        return path_open(self, *args, **kwargs)
    pathlib.Path.open = open_spy

    def sweep(key, **kw):
        # the points' fields but elapsed_s, and the collectives this sweep made
        before = dict(calls)
        pts = waterfall(**{**spec["sweeps"][key], **kw}, device="cpu", mesh=mesh)
        fields = [[getattr(p, f) for f in spec["fields"]] for p in pts]
        return fields, {k: calls[k] - before[k] for k in calls}

    out = {"rank": mesh.rank, "world": mesh.world_size}
    for key, keep in spec["keep"].items():
        ck = work / f"{key}.jsonl"
        out[key + "_plain"] = sweep(key)
        out[key + "_full"] = sweep(key, checkpoint=ck)
        if rank == 0:  # the interruption
            shutil.copy(ck, work / f"{key}_full.jsonl")
            ck.write_text("\\n".join(ck.read_text().splitlines()[:keep]) + "\\n")
            shutil.copy(ck, work / f"{key}_cut.jsonl")
        dist.barrier()
        out[key + "_resumed"] = sweep(key, checkpoint=ck)
        out[key + "_again"] = sweep(key, checkpoint=ck)
    out["from_one"] = sweep("ms", checkpoint=work / "one_cut.jsonl")
    try:
        sweep("ms", checkpoint=work / "ms.jsonl", maxiters=7)
        out["mismatch"] = None
    except ValueError as e:
        out["mismatch"] = str(e)
    out["opened"] = sorted(set(n for n in opened if n.endswith(".jsonl")))

    inputs = np.load(work / "inputs.npz")
    rx = torch.from_numpy(inputs["bf_rx"])
    res = make_sharded_bf_decoder(spec["bf_code"], mesh, spec["bf_iters"], impl="qc")(rx)
    np.savez(work / f"bf_r{rank}.npz", *[r.numpy() for r in res])
    for j, (code, dtype, impl, iters) in enumerate(spec["decoders"]):
        x = torch.from_numpy(inputs[f"dec{j}"])
        if dtype == "bf":
            decode = shard_decoder(_make_bf_decoder(code, iters, impl, cpu), mesh)
        else:
            x = x.to(getattr(torch, dtype))
            decode = shard_decoder(_make_decoder(code, x.dtype, iters, None, impl, cpu), mesh)
        res = decode(x)
        np.savez(work / f"dec{j}_r{rank}.npz", *[r.numpy() for r in res])
        out.setdefault("types", []).append(type(res).__name__)
    (work / f"rank{rank}.json").write_text(json.dumps(out))
    dist.destroy_process_group()
""")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run PyTorch's CPU ops on one thread (tests/test_torch_layered.py)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _received(name, batch, seed, p):
    """(B, n) uint8 hard bits of random codewords through a BSC(p)."""
    code = T.get_code(name)
    rng = np.random.default_rng(seed)
    cw = T.encode_bits(code, rng.integers(0, 2, (batch, code.k), dtype=np.uint8), "cpu").numpy()
    return cw ^ (rng.random(cw.shape) < p).astype(np.uint8)


def _decoder_input(j):
    """The numpy input of DECODERS[j]: hard bits for "bf", true LLRs
    2y/sigma^2 at Eb/N0 1.5 dB for sum-product, else float32 soft LLRs
    (quantized for int8)."""
    code, dtype, impl, _ = DECODERS[j]
    if dtype == "bf":
        return _received(code, 16, j, 0.03)
    c = T.get_code(code)
    rng = np.random.default_rng(j)
    cw = T.encode_bits(c, rng.integers(0, 2, (16, c.k), dtype=np.uint8), "cpu").numpy()
    sigma = awgn.noise_sigma(1.5, c, "ebn0")
    y = (1.0 - 2.0 * cw + rng.normal(0, sigma, cw.shape)).astype(np.float32)
    if impl == "sp_layered":
        return y * np.float32(2.0 / sigma**2)
    if dtype == "int8":
        return quantize_llrs(torch.from_numpy(y), torch.int8).numpy()
    return y


def _fields(pts):
    return [[getattr(p, f) for f in FIELDS] for p in pts]


def _sweep(key, **kw):
    return waterfall(**{**SWEEPS[key], **kw}, device="cpu")


def _records(path):
    """The file's lines as dicts, elapsed_s dropped."""
    return [{k: v for k, v in json.loads(line).items() if k != "elapsed_s"}
            for line in Path(path).read_text().splitlines()]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Run RANK_PROGRAM on two Gloo ranks and the dry run beside them;
    returns (the ranks' results, their work directory, the dry run's stdout)."""
    work = tmp_path_factory.mktemp("mesh_resume")
    spec = {"sweeps": SWEEPS, "keep": KEEP, "fields": FIELDS, "decoders": DECODERS,
            "bf_code": "TM1280", "bf_iters": BF_ITERS}
    (work / "spec.json").write_text(json.dumps(spec))
    # a one-rank checkpoint of the "ms" sweep, cut inside its second point
    one = work / "one_cut.jsonl"
    _sweep("ms", checkpoint=one)
    one.write_text("\n".join(one.read_text().splitlines()[:KEEP["ms"]]) + "\n")
    np.savez(work / "inputs.npz", bf_rx=_received("TM1280", 32, 11, 0.008),
             **{f"dec{j}": _decoder_input(j) for j in range(len(DECODERS))})
    env = dict(os.environ, OMP_NUM_THREADS="1")
    port = free_port()
    outs = run_processes(
        [[sys.executable, "-c", RANK_PROGRAM, str(r), str(port), str(work)] for r in (0, 1)]
        + [[sys.executable, "-m", "labrador_ldpc_tpu_torch.entry", "2"]],
        timeout=240, cwd=REPO, env=env)
    ranks = [json.loads((work / f"rank{r}.json").read_text()) for r in (0, 1)]
    return ranks, work, outs[2]


@pytest.fixture(scope="module")
def uninterrupted():
    """The one-rank sweeps, no checkpoint: their points' fields."""
    return {key: _fields(_sweep(key)) for key in SWEEPS}


@pytest.mark.parametrize("key", list(SWEEPS))
def test_two_rank_resume_equals_uninterrupted(two_ranks, uninterrupted, key):
    """A two-rank sweep, checkpointed, cut and resumed on two ranks, gives
    every field of the uninterrupted one-rank sweep on every rank; so do the
    two-rank sweeps without a checkpoint and with one from the start."""
    want = uninterrupted[key]
    assert want[0][FIELDS.index("bit_errors")] > 0  # the counters say something
    for r in two_ranks[0]:
        for run in ("plain", "full", "resumed", "again"):
            assert r[f"{key}_{run}"][0] == want, (r["rank"], run)


@pytest.mark.parametrize("key", list(SWEEPS))
def test_one_writer(two_ranks, tmp_path, key):
    """The two-rank file holds one config line and exactly the point lines of
    a one-rank checkpoint of the same sweep (elapsed_s aside), before the cut
    and after the resume: one writer."""
    one = tmp_path / "one.jsonl"
    _sweep(key, checkpoint=one)
    want = _records(one)
    assert [rec["kind"] for rec in want].count("config") == 1
    work = two_ranks[1]
    assert _records(work / f"{key}_full.jsonl") == want
    assert _records(work / f"{key}.jsonl") == want


def test_two_rank_file_resumes_on_one_rank(two_ranks, uninterrupted, tmp_path):
    """A checkpoint written by two ranks, cut, resumes on one rank with no
    mesh to the uninterrupted counters."""
    for key in SWEEPS:
        ck = tmp_path / f"{key}.jsonl"
        ck.write_text((two_ranks[1] / f"{key}_cut.jsonl").read_text())
        assert len(ck.read_text().splitlines()) == KEEP[key]
        assert _fields(_sweep(key, checkpoint=ck)) == uninterrupted[key]


def test_one_rank_file_resumes_on_two_ranks(two_ranks, uninterrupted):
    """A one-rank checkpoint cut inside its second point resumes on two
    ranks to the uninterrupted counters, on every rank."""
    for r in two_ranks[0]:
        assert r["from_one"][0] == uninterrupted["ms"]


def test_only_rank_0_opens_the_file(two_ranks):
    """Rank 1 opens no checkpoint file; rank 0 opens every one."""
    ranks = two_ranks[0]
    assert ranks[1]["opened"] == []
    assert ranks[0]["opened"] == ["bf.jsonl", "ms.jsonl", "one_cut.jsonl"]


def test_mismatch_raises_on_every_rank(two_ranks):
    """A config mismatch, seen by rank 0 alone, raises the same ValueError on
    both ranks (and both exit: the fixture's processes returned 0)."""
    msgs = [r["mismatch"] for r in two_ranks[0]]
    assert msgs[0] is not None and "different parameters" in msgs[0] and "maxiters" in msgs[0]
    assert msgs[1] == msgs[0]


def test_finished_sweep_calls_no_step(two_ranks):
    """A finished sweep re-run on two ranks calls no trial step (no
    all_reduce of counters) and makes the one broadcast of the open."""
    for r in two_ranks[0]:
        for key in SWEEPS:
            assert r[f"{key}_again"][1] == {"broadcast_object_list": 1, "all_reduce": 0}


def test_one_broadcast_no_collective_per_batch(two_ranks):
    """A checkpointed sweep makes exactly one broadcast_object_list and the
    all_reduces of the sweep without a checkpoint (one a batch): the writes
    add no collective. The resumed sweep makes one broadcast and one
    all_reduce for each batch it runs."""
    for r in two_ranks[0]:
        for key in SWEEPS:
            plain, full, resumed = (r[f"{key}_{run}"][1] for run in ("plain", "full", "resumed"))
            batches = 3 * len(SWEEPS[key]["snrs_db"])
            assert plain == {"broadcast_object_list": 0, "all_reduce": batches}
            assert full == {"broadcast_object_list": 1, "all_reduce": batches}
            assert resumed == {"broadcast_object_list": 1, "all_reduce": RESUMED_BATCHES[key]}


def test_sharded_bf_decoder_matches_jax(two_ranks):
    """make_sharded_bf_decoder(impl="qc") on two ranks == the JAX
    shard_map_decoder(make_bf_decoder_qc, result_type=BFResult) on the
    8-device CPU mesh, same numpy hard bits; some frames fail."""
    rx = np.load(two_ranks[1] / "inputs.npz")["bf_rx"]
    jmesh = jmake_batch_mesh()
    assert jmesh.size == 8
    dec = jax.jit(jshard_map_decoder(jmake_bf_decoder_qc("TM1280", BF_ITERS), jmesh,
                                     result_type=JBFResult))
    want = dec(jnp.asarray(rx))
    for r in (0, 1):
        got = np.load(two_ranks[1] / f"bf_r{r}.npz")
        success, iterations, bits = (got[f"arr_{i}"] for i in range(3))  # BFResult order
        assert np.array_equal(bits, np.asarray(want.bits))
        assert np.array_equal(success, np.asarray(want.success))
        assert np.array_equal(iterations, np.asarray(want.iterations))
    assert 0 < success.sum() < len(success)


@pytest.mark.parametrize("j", range(len(DECODERS)), ids=lambda j: "-".join(map(str, DECODERS[j])))
def test_shard_decoder_equals_unsharded(two_ranks, j):
    """shard_decoder on two ranks == the unsharded decoder (the kernels'
    plain versions on the CPU), on every rank: the result type, bits,
    success, iterations."""
    code, dtype, impl, iters = DECODERS[j]
    x = torch.from_numpy(np.load(two_ranks[1] / "inputs.npz")[f"dec{j}"])
    if dtype == "bf":
        want = _make_bf_decoder(code, iters, impl, "cpu")(x)
    else:
        x = x.to(getattr(torch, dtype))
        want = _make_decoder(code, x.dtype, iters, None, impl, "cpu")(x)
    for r in (0, 1):
        assert two_ranks[0][r]["types"][j] == type(want).__name__
        got = np.load(two_ranks[1] / f"dec{j}_r{r}.npz")
        for i, field in enumerate(want):
            assert np.array_equal(got[f"arr_{i}"], field.numpy()), (r, want._fields[i])
    assert 0 < int(want.success.sum()) < len(want.success) or int(want.iterations.max()) > 1


def test_dryrun_certifies_every_jax_configuration(two_ranks):
    """`python -m labrador_ldpc_tpu_torch.entry 2` certifies a counterpart of
    each of the 10 configurations of __graft_entry__.py (three trial steps
    at :109, one each at :138, :161, :185, :205, :224, :233, :262) and
    returns."""
    out = two_ranks[2]
    lines = [line for line in out.splitlines() if line.startswith("DRYRUN OK: ")]
    tags = collections.Counter(re.search(r"\[(.*)\]$", line).group(1) for line in lines)
    jax_lines = {t: n for t, n in tags.items() if t != "port"}
    assert jax_lines == {f"__graft_entry__.py:{n}": 3 if n == 109 else 1
                         for n in (109, 138, 161, 185, 205, 224, 233, 262)}
    assert f"{len(lines)}/{len(lines)} configurations certified over 2 ranks" in out


def test_mesh_of_one_rank():
    """Without a process group broadcast_object returns its object and
    shard_decoder is the decoder, its result type kept; the JAX-named
    channel.awgn.shard_map_decoder gives the same and raises a TypeError
    when the result is not its result_type."""
    mesh = make_batch_mesh(device="cpu")
    obj = {"points": {2.0: 1}}
    assert broadcast_object(mesh, obj) is obj
    x = torch.from_numpy(_decoder_input(3))
    decoder = _make_bf_decoder("TM1280", 8, "qc", "cpu")
    want = decoder(x)
    got = shard_decoder(decoder, mesh)(x)
    assert type(got) is BFResult
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    got = awgn.shard_map_decoder(decoder, mesh, result_type=BFResult)(x)
    assert type(got) is BFResult
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(TypeError, match="not the result_type MSResult"):
        awgn.shard_map_decoder(decoder, mesh)(x)
