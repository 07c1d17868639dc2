"""The port's data parallelism (parallel/) on the CPU: two Gloo ranks against
one rank, and the sharded decoder against the JAX package's.

One module fixture starts two rank processes over Gloo once (as
tests/test_distributed.py does for the JAX package) and runs every two-rank
case in them, beside the two processes of the launch CLI. Each rank draws
the whole global batch from the same generator and decodes its half, and the
counters are summed with `all_reduce`, so the global counters must equal the
one-rank run's exactly, for every impl and dtype below. The sharded decoder
must equal the JAX `make_sharded_decoder` on the 8-device CPU mesh in bits,
success and iterations on the same numpy LLRs (the JAX twins and the port's
plain decoders are bit-exact, tests/test_torch_layered.py and
tests/test_torch_int.py). Tolerance: exact everywhere.
"""

import json
import os
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from labrador_ldpc_tpu.parallel import make_batch_mesh as jmake_batch_mesh
from labrador_ldpc_tpu.parallel import make_sharded_decoder as jmake_sharded_decoder

import labrador_ldpc_tpu_torch as T
from labrador_ldpc_tpu_torch.channel.awgn import make_trial_step, noise_sigma, quantize_llrs
from labrador_ldpc_tpu_torch.channel.hard import make_bf_trial_step, make_ms_hard_trial_step
from labrador_ldpc_tpu_torch.channel.waterfall import _batch_generator, waterfall
from labrador_ldpc_tpu_torch.entry import entry
from labrador_ldpc_tpu_torch.parallel import make_batch_mesh, make_sharded_trial_step
from labrador_ldpc_tpu_torch.parallel.launch import free_port, run_processes

REPO = Path(__file__).resolve().parent.parent
TRIALS = 64  # the global batch: 32 rows a rank

# (code, surface, dtype, impl, maxiters, channel parameter): sigma of the
# perftest noise model at 1.2 dB for "ms", a flip probability for the others
STEP_CASES = [
    (code, "ms", dtype, impl, iters, float(10.0 ** -0.12))
    for code, iters in (("TC128", 20), ("TM1280", 10))
    for impl, dtype in (("layered", "float32"), ("qc_i8", "int8"), ("qc", "int16"),
                        ("ref", "float32"), ("cuda_layered", "float32"),
                        ("sp_layered", "float32"), ("cuda_qc", "bfloat16"))
] + [
    ("TC128", "bf", "float32", "auto", 20, 0.03),
    ("TM1280", "bf", "float32", "auto", 10, 0.01),
    ("TC128", "ms_hard", "float32", "auto", 20, 0.03),
]
# (code, dtype, impl, maxiters, noise std) of the sharded decoders held to JAX
DECODER_CASES = [("TC256", "int8", "qc", 30, 0.6), ("TM1280", "float32", "layered", 20, 0.5)]
SWEEP = dict(snrs="0.0,2.0", batch=32, maxiters=10, max_bits=32 * 64 * 2, seed=3)

# one rank: runs every two-rank case and writes its results as JSON
RANK_PROGRAM = textwrap.dedent("""
    import json, sys
    import numpy as np, torch
    torch.set_num_threads(1)
    from labrador_ldpc_tpu_torch.channel.awgn import make_trial_step
    from labrador_ldpc_tpu_torch.channel.hard import make_bf_trial_step, make_ms_hard_trial_step
    from labrador_ldpc_tpu_torch.channel.waterfall import _batch_generator, waterfall
    from labrador_ldpc_tpu_torch.parallel import make_batch_mesh, make_sharded_decoder
    from labrador_ldpc_tpu_torch.parallel.launch import initialize
    rank, port, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    spec = json.load(open(f"{work}/spec.json"))
    initialize(f"127.0.0.1:{port}", 2, rank, device="cpu")
    mesh = make_batch_mesh(device="cpu")
    cpu = torch.device("cpu")
    out = {"rank": mesh.rank, "world": mesh.world_size, "backend": mesh.backend, "steps": []}
    for i, (code, surface, dtype, impl, iters, param) in enumerate(spec["steps"]):
        if surface == "ms":
            step = make_trial_step(code, spec["trials"], iters, dtype, None, impl, None, "cpu",
                                   mesh=mesh)
        else:
            make = make_bf_trial_step if surface == "bf" else make_ms_hard_trial_step
            step = make(code, spec["trials"], iters, "bsc", impl, "cpu", mesh=mesh)
        out["steps"].append([int(x) for x in step(_batch_generator(5, i, cpu), param)])
    llrs = np.load(f"{work}/llrs.npz")
    for j, (code, dtype, impl, iters, _) in enumerate(spec["decoders"]):
        res = make_sharded_decoder(code, mesh, getattr(torch, dtype), iters, None, impl)(
            torch.from_numpy(llrs[f"arr_{j}"]))
        if rank == 0:
            np.savez(f"{work}/dec{j}.npz", *[r.numpy() for r in res])
    pts = waterfall("TC128", [0.0, 2.0], batch=32, maxiters=10, max_bits=4096, seed=3,
                    device="cpu", mesh=mesh)
    out["waterfall"] = [p.csv() for p in pts]
    try:
        make_trial_step("TC128", 63, 10, device="cpu", mesh=mesh)
        out["uneven"] = None
    except ValueError as e:
        out["uneven"] = str(e)
    json.dump(out, open(f"{work}/rank{rank}.json", "w"))
    torch.distributed.destroy_process_group()
""")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run PyTorch's CPU ops on one thread (tests/test_torch_layered.py)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _decoder_llrs(code_name, dtype, std):
    """Seeded noisy (16, n) LLRs of the decoder cases, numpy."""
    code = T.get_code(code_name)
    rng = np.random.default_rng(3)
    data = rng.integers(0, 2, (16, code.k), dtype=np.uint8)
    cw = T.encode_bits(code, data, "cpu").numpy()
    soft = (1.0 - 2.0 * cw + rng.normal(0, std, cw.shape)).astype(np.float32)
    if dtype == "int8":
        return quantize_llrs(torch.from_numpy(soft), torch.int8).numpy()
    return soft


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Run RANK_PROGRAM on two Gloo ranks and the launch CLI on two more
    processes, all at once; returns (rank results, CLI stdouts)."""
    work = tmp_path_factory.mktemp("ranks")
    spec = {"trials": TRIALS, "steps": STEP_CASES, "decoders": DECODER_CASES}
    (work / "spec.json").write_text(json.dumps(spec))
    np.savez(work / "llrs.npz", *[_decoder_llrs(c, d, s) for c, d, _, _, s in DECODER_CASES])
    env = dict(os.environ, OMP_NUM_THREADS="1")
    port, cli_port = free_port(), free_port()
    cli = ["--device", "cpu", "--coordinator", f"127.0.0.1:{cli_port}", "--num-processes", "2",
           "--code", "TC128", "--snrs", SWEEP["snrs"], "--batch", str(SWEEP["batch"]),
           "--maxiters", str(SWEEP["maxiters"]), "--max-bits", str(SWEEP["max_bits"]),
           "--seed", str(SWEEP["seed"])]
    outs = run_processes(
        [[sys.executable, "-c", RANK_PROGRAM, str(r), str(port), str(work)] for r in (0, 1)]
        + [[sys.executable, "-m", "labrador_ldpc_tpu_torch.parallel.launch", *cli,
            "--process-id", str(r)] for r in (0, 1)],
        timeout=240, cwd=REPO, env=env)
    ranks = [json.loads((work / f"rank{r}.json").read_text()) for r in (0, 1)]
    decoded = [np.load(work / f"dec{j}.npz") for j in range(len(DECODER_CASES))]
    return ranks, decoded, outs[2:]


@pytest.mark.parametrize("case", STEP_CASES, ids=lambda c: "-".join(map(str, c[:4])))
def test_two_ranks_equal_one_rank(two_ranks, case):
    """Global counters of the batch split over two ranks == one rank's."""
    code, surface, dtype, impl, iters, param = case
    i = STEP_CASES.index(case)
    if surface == "ms":
        step = make_trial_step(code, TRIALS, iters, dtype, None, impl, None, "cpu")
    else:
        make = make_bf_trial_step if surface == "bf" else make_ms_hard_trial_step
        step = make(code, TRIALS, iters, "bsc", impl, "cpu")
    want = [int(x) for x in step(_batch_generator(5, i, torch.device("cpu")), param)]
    ranks = two_ranks[0]
    assert want[0] == TRIALS
    assert ranks[0]["steps"][i] == want
    assert ranks[1]["steps"][i] == want  # every rank reads the global counters


def test_two_rank_cases_are_not_trivial(two_ranks):
    """The step cases see errors and decode failures, so equal counters say
    something; the mesh reports two Gloo ranks."""
    ranks = two_ranks[0]
    assert [(r["rank"], r["world"], r["backend"]) for r in ranks] == [(0, 2, "gloo"),
                                                                      (1, 2, "gloo")]
    steps = ranks[0]["steps"]
    assert sum(s[1] > 0 for s in steps) >= len(steps) // 2
    assert any(s[3] > 0 for s in steps)


@pytest.mark.parametrize("case", DECODER_CASES, ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}")
def test_sharded_decoder_matches_jax(two_ranks, case):
    """The port's make_sharded_decoder on two ranks == the JAX
    make_sharded_decoder on the 8-device CPU mesh, same numpy LLRs."""
    code, dtype, impl, iters, std = case
    j = DECODER_CASES.index(case)
    llrs = _decoder_llrs(code, dtype, std)
    want = jmake_sharded_decoder(code, jmake_batch_mesh(), getattr(jnp, dtype), maxiters=iters,
                                 impl=impl)(jnp.asarray(llrs))
    got = two_ranks[1][j]
    success, iterations, bits = (got[f"arr_{i}"] for i in range(3))  # MSResult order
    assert np.array_equal(bits, np.asarray(want.bits))
    assert np.array_equal(success, np.asarray(want.success))
    assert np.array_equal(iterations, np.asarray(want.iterations))
    assert 0 < success.sum() < len(success) or iterations.max() > 1


def test_launch_cli_two_processes_match_one(two_ranks):
    """`python -m labrador_ldpc_tpu_torch.parallel.launch` on two processes
    prints the CSV of the one-process waterfall; rank 1 prints none."""
    out0, out1 = two_ranks[2]
    rows = [line for line in out0.splitlines() if line.startswith("TC128,")]
    assert not [line for line in out1.splitlines() if line.startswith("TC128,")]
    pts = waterfall("TC128", [float(s) for s in SWEEP["snrs"].split(",")], batch=SWEEP["batch"],
                    maxiters=SWEEP["maxiters"], max_bits=SWEEP["max_bits"], seed=SWEEP["seed"],
                    device="cpu")
    assert rows == [p.csv() for p in pts]
    assert pts[0].bit_errors > 0
    # waterfall(mesh=...) in the rank program: every rank returns these points
    ranks = two_ranks[0]
    want = [p.csv() for p in waterfall("TC128", [0.0, 2.0], batch=32, maxiters=10,
                                       max_bits=4096, seed=3, device="cpu")]
    assert ranks[0]["waterfall"] == ranks[1]["waterfall"] == want


@pytest.mark.parametrize("key,match", [("uneven", "does not divide")])
def test_two_ranks_refuse(two_ranks, key, match):
    """A global batch that does not divide by the ranks raises ValueError on
    every rank (a checkpoint on two ranks works:
    tests/test_torch_mesh_resume.py)."""
    for r in two_ranks[0]:
        assert r[key] is not None and match in r[key], r[key]


def test_mesh_of_one_rank(tmp_path):
    """Without a process group the mesh is this process alone: the trial
    step and the waterfall give the unsharded counters, and a checkpoint
    works as without a mesh."""
    mesh = make_batch_mesh(device="cpu")
    assert (mesh.rank, mesh.world_size, mesh.backend) == (0, 1, None)
    cpu = torch.device("cpu")
    step = make_sharded_trial_step("TC128", 32, mesh, 10, torch.int8, impl="qc_i8")
    one = make_trial_step("TC128", 32, 10, "int8", None, "qc_i8", None, "cpu")
    sigma = noise_sigma(1.0, T.get_code("TC128"))
    assert [int(x) for x in step(_batch_generator(1, 0, cpu), sigma)] == \
        [int(x) for x in one(_batch_generator(1, 0, cpu), sigma)]
    kw = dict(batch=32, maxiters=10, max_bits=32 * 64 * 2, seed=4, device="cpu")
    got = waterfall("TC128", [1.0], mesh=mesh, checkpoint=tmp_path / "ck.jsonl", **kw)
    assert [p.csv() for p in got] == [p.csv() for p in waterfall("TC128", [1.0], **kw)]


def test_entry_runs_on_cpu():
    """entry() builds the TM8192, B=128 decode step; on the CPU "auto" is the
    plain layered decoder, and every frame decodes to the data sent."""
    fn, (llrs,) = entry(device="cpu")
    assert llrs.shape == (128, 8192) and llrs.device.type == "cpu"
    res = fn(llrs)
    assert bool(res.success.all())
    data = T.pack_bits(res.bits[:, :4096], "cpu")
    rng = np.random.default_rng(0)
    assert np.array_equal(data.numpy(), rng.integers(0, 256, (128, 512), dtype=np.uint8))
