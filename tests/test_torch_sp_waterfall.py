"""The belief-propagation waterfall (`TM8192_SP`, the benchmark cell
`tm8192.sp_ebn0_sweep`) on the CPU, against the benchmark's plain reference
(`portbench/reference/sumproduct.py`), with no JAX.

Held: the port's true-LLR channel (`channel/awgn._awgn_true_llrs`) equals
the reference's `true_llrs` bit for bit; the port's `sp_layered` decoder (on
the CPU its plain version, `ops/sumproduct.layered_sp_plain`) equals the
reference's `layered_sp` in bits, success and iterations at maxiters 100, at
TM8192 0.9 and 1.2 dB, at 0.5 dB where frames fail and run to maxiters, and
at TC512; a two-point `waterfall(..., impl="sp_layered")` gives the five
counters of the cell driver's replay of each point under the same seed (the
seeding rule, the stopping rule and the true-LLR rounding); under a CPU-only
`torch.profiler` that waterfall opens the spans the cell's per-layer
metrics read; the cell's dry run exits 0 with no point wrong. About 40 s
alone.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from labrador_ldpc_tpu_torch.channel.awgn import _awgn_true_llrs
from labrador_ldpc_tpu_torch.channel.waterfall import waterfall
from labrador_ldpc_tpu_torch.ops.cuda_sp import layered_sp as port_layered_sp
from portbench.drivers.sp_waterfall import replay
from portbench.drivers.waterfall import COUNTERS
from portbench.reference import channel
from portbench.reference.codes import code
from portbench.reference.sumproduct import layered_sp, true_llrs

REPO = Path(__file__).resolve().parent.parent
CELL = "tm8192.sp_ebn0_sweep"
TRAFFIC = json.loads((REPO / "portbench/traffic/sp_ebn0_sweep.json").read_text())
CONFIG = json.loads((REPO / "portbench/configs/TM8192_SP.json").read_text())
MAXITERS = CONFIG["decoder"]["maxiters"]
SEED = 2_147_483_659  # above 2**31
SPANS = ("ldpc.trial_step", "ldpc.draw", "ldpc.encode", "ldpc.channel", "ldpc.decode",
         "ldpc.count", "ldpc.waterfall.point", "ldpc.waterfall.drain")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run PyTorch's CPU ops on one thread (tests/test_torch_layered.py)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def frames(name: str, ebn0_db: float, n: int, seed: int):
    """Seeded codewords of the reference, their noise and sigma at `ebn0_db`."""
    c = code(name)
    rng = np.random.default_rng(seed)
    data = torch.from_numpy(rng.integers(0, 2, (n, c.k)).astype(np.uint8))
    noise = torch.from_numpy(rng.standard_normal((n, c.n)).astype(np.float32))
    return channel.encode(name, data), noise, channel.ebn0_sigma(ebn0_db, c.k / c.n)


def test_sizes_match_configuration():
    c = code(CONFIG["code"])
    assert (c.n, c.k, c.punctured, c.m, c.n_vars, c.n_checks, c.edges) == (
        CONFIG["n"], CONFIG["k"], CONFIG["punctured_bits"], CONFIG["submatrix_size"],
        CONFIG["n_vars"], CONFIG["n_checks"], CONFIG["edges"])
    assert [len(row) for row in c.rows] == [3, 6, 6]


@pytest.mark.parametrize("name,ebn0_db,n,seed", [
    ("TM8192", 0.9, 24, 1), ("TM8192", 1.2, 24, 2), ("TM8192", 0.5, 8, 3), ("TC512", 2.0, 48, 4)])
def test_sp_layered_equals_reference(name, ebn0_db, n, seed):
    cw, noise, sigma = frames(name, ebn0_db, n, seed)
    llrs = true_llrs(channel.bpsk_awgn(cw, noise, sigma), sigma)
    assert torch.equal(_awgn_true_llrs(cw, noise, sigma), llrs)
    want = layered_sp(code(name), llrs, MAXITERS)
    got = port_layered_sp(name, llrs, MAXITERS)
    assert torch.equal(got.bits, want.bits)
    assert torch.equal(got.success, want.success)
    assert got.iterations.tolist() == want.iterations.tolist()
    failed = int((~want.success).sum())
    if ebn0_db < 0.8:
        # frames that fail run to maxiters, and the port agrees on them too
        assert failed > 0 and (want.iterations[~want.success] == MAXITERS).all()
    elif name == "TM8192" and ebn0_db > 1.0:
        assert failed == 0


def test_waterfall_equals_replay():
    """Two points of 2 batches each in one call: the second point starts at
    sweep batch 2, with 2 batches in flight."""
    kw = dict(batch=32, max_bits=64 * CONFIG["k"], max_bit_errors=TRAFFIC["max_bit_errors"],
              noise_model="ebn0", pipeline_depth=2)
    points = waterfall("TM8192", [0.9, 1.2], maxiters=MAXITERS, impl=CONFIG["decoder"]["impl"],
                       device="cpu", seed=SEED, **kw)
    first = 0
    for pt in points:
        want = replay("TM8192", kw, SEED, pt.snr_db, first, MAXITERS, torch.device("cpu"))
        assert {f: getattr(pt, f) for f in COUNTERS} == {f: getattr(want, f) for f in COUNTERS}
        first += pt.trials // kw["batch"]
    assert [pt.trials for pt in points] == [64, 64]


def test_waterfall_opens_the_cells_spans(tmp_path):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        waterfall("TM8192", [1.2], batch=4, maxiters=MAXITERS, max_bits=4 * CONFIG["k"],
                  noise_model="ebn0", impl=CONFIG["decoder"]["impl"], device="cpu", seed=SEED)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    names = {e["name"] for e in json.loads(path.read_text())["traceEvents"]
             if e.get("ph") == "X" and e["name"].startswith("ldpc.")}
    assert set(SPANS) <= names, names


def test_cell_dry_run():
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", CELL,
                          "--seed", "4294967311", "--seconds", "1", "--trace", "0", "--dry-run"],
                         cwd=REPO, capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1",
                              "PYTHONPATH": str(REPO)})
    assert out.returncode == 0, out.stderr[-3000:]
    assert "check points_wrong: 0 (limit 0) ok" in out.stderr
