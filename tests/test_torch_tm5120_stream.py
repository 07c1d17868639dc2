"""The rate-4/5 telemetry stream (`TM5120`, the benchmark cell
`tm5120.stream_f32_3p15db`) on the CPU, against the benchmark's plain
reference (`portbench/reference/`, TM5120's tables in `tm_r45.py`), with no
JAX.

Held: the reference's frozen TM5120 tables expand to the port's edge set and
parity generator (`codes/expand.py`); the reference's codewords of seeded
random data have zero syndrome (the punctured bits solved for over GF(2));
`decode_ms("TM5120", ..., impl="auto")`, the stream's decode, equals the
reference's `layered_minsum` in bits, success and iterations at maxiters 50,
at the cell's 3.15 dB and at 2.75 dB, where some frames fail and run to
maxiters; under a CPU-only `torch.profiler` that decode opens the spans the
cell's per-layer metrics read; the cell's dry run exits 0 with no frame
wrong. About 20 s alone.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from labrador_ldpc_tpu_torch.codes.expand import generator_parity_matrix, parity_edges
from labrador_ldpc_tpu_torch.ops.minsum import decode_ms
from portbench.reference import channel, tm_r45  # noqa: F401  (tm_r45 registers TM5120)
from portbench.reference.codes import code, generator_parity
from portbench.reference.decoders import layered_minsum
from portbench.tests.test_reference import edges

REPO = Path(__file__).resolve().parent.parent
CELL = "tm5120.stream_f32_3p15db"
TRAFFIC = json.loads((REPO / "portbench/traffic/stream_f32_3p15db.json").read_text())
CONFIG = json.loads((REPO / "portbench/configs/TM5120.json").read_text())
MAXITERS = CONFIG["decoder"]["maxiters"]
SPANS = ("ldpc.decode_ms", "ldpc.copy_in", "ldpc.decode")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run PyTorch's CPU ops on one thread (tests/test_torch_layered.py)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def stream_frames(ebn0_db: float, frames: int, seed: int) -> torch.Tensor:
    """Seeded BPSK frames of the reference's codewords over AWGN at `ebn0_db`."""
    c = code("TM5120")
    rng = np.random.default_rng(seed)
    data = torch.from_numpy(rng.integers(0, 2, (frames, c.k)).astype(np.uint8))
    noise = torch.from_numpy(rng.standard_normal((frames, c.n)).astype(np.float32))
    sigma = channel.ebn0_sigma(ebn0_db, c.k / c.n)
    return channel.bpsk_awgn(channel.encode("TM5120", data), noise, sigma)


def test_sizes_match_configuration():
    c = code("TM5120")
    assert (c.n, c.k, c.punctured, c.m, c.n_vars, c.n_checks, c.edges) == (
        CONFIG["n"], CONFIG["k"], CONFIG["punctured_bits"], CONFIG["submatrix_size"],
        CONFIG["n_vars"], CONFIG["n_checks"], CONFIG["edges"])
    assert max(len(row) for row in c.rows) == 18 and sum(len(r) for r in c.rows) == 39


@pytest.mark.parametrize("table", ["edges", "generator"])
def test_frozen_tables_equal_the_ports(table):
    if table == "edges":
        port = parity_edges("TM5120")
        port = port[np.lexsort((port[:, 1], port[:, 0]))]
        np.testing.assert_array_equal(edges("TM5120"), port)
    else:
        np.testing.assert_array_equal(generator_parity("TM5120"), generator_parity_matrix("TM5120"))


def test_codewords_have_zero_syndrome():
    """H = [H_n | H_p] over the transmitted and the punctured variables: the
    punctured bits p solve H_p p = H_n x for every codeword x of seeded data,
    and a codeword with one bit flipped has no solution."""
    c = code("TM5120")
    rng = np.random.default_rng(5120)
    data = torch.from_numpy(rng.integers(0, 2, (24, c.k)).astype(np.uint8))
    cw = channel.encode("TM5120", data).numpy()
    bad = cw[:1].copy()
    bad[0, 17] ^= 1
    h = np.zeros((c.n_checks, c.n_vars), dtype=np.uint8)
    e = edges("TM5120")
    np.add.at(h, (e[:, 0], e[:, 1]), 1)
    h &= 1
    x = np.concatenate([cw, bad])
    rhs = (h[:, :c.n].astype(np.int64) @ x.T.astype(np.int64) & 1).astype(bool)
    # Gaussian elimination over GF(2) of [H_p | rhs]
    a = np.concatenate([h[:, c.n:].astype(bool), rhs], axis=1)
    r = 0
    for col in range(c.punctured):
        pivot = np.flatnonzero(a[r:, col])
        if not len(pivot):
            continue
        a[[r, r + pivot[0]]] = a[[r + pivot[0], r]]
        others = np.flatnonzero(a[:, col])
        a[others[others != r]] ^= a[r]
        r += 1
    consistent = ~a[r:, c.punctured:].any(axis=0)
    assert consistent[:-1].all() and not consistent[-1]


@pytest.mark.parametrize("ebn0_db,frames,seed", [(TRAFFIC["ebn0_db"], 48, 1), (2.75, 64, 3)])
def test_decode_ms_equals_reference(ebn0_db, frames, seed):
    y = stream_frames(ebn0_db, frames, seed)
    want = layered_minsum(code("TM5120"), y, MAXITERS)
    got = decode_ms("TM5120", y, maxiters=MAXITERS, impl=CONFIG["decoder"]["impl"], device="cpu")
    assert torch.equal(got.bits, want.bits)
    assert torch.equal(got.success, want.success)
    assert got.iterations.tolist() == want.iterations.tolist()
    failed = int((~want.success).sum())
    if ebn0_db < 3:
        # frames that fail run to maxiters, and the port agrees on them too
        assert failed > 0 and (want.iterations[~want.success] == MAXITERS).all()
    else:
        assert failed == 0


def test_decode_opens_the_cells_spans(tmp_path):
    y = stream_frames(TRAFFIC["ebn0_db"], 4, 7)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        decode_ms("TM5120", y, maxiters=MAXITERS, impl="auto", device="cpu")
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    names = [e["name"] for e in json.loads(path.read_text())["traceEvents"]
             if e.get("ph") == "X" and e["name"].startswith("ldpc.")]
    assert all(names.count(s) == 1 for s in SPANS), names


def test_cell_dry_run():
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", CELL,
                          "--seed", "4294967311", "--seconds", "1", "--trace", "0", "--dry-run"],
                         cwd=REPO, capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1",
                              "PYTHONPATH": str(REPO)})
    assert out.returncode == 0, out.stderr[-3000:]
    assert "check frames_wrong: 0 (limit 0) ok" in out.stderr
