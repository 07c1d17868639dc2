"""The cell `tm8192.sp_ebn0_sweep`: the reference's belief propagation
(`reference/sumproduct.py`) against frozen vectors (true LLRs and layered BP
decodes of TM8192 and TC512 recorded once on the CPU, in `vectors_sp.json`),
the sum-product roofline's count, the cell's judge on the CPU with the timed
path broken as `test_faults.py` breaks it, and its bfloat16 control, on the
CPU and, marked `card`, at the cell's own sizes on the card:

    python -m pytest portbench/tests/test_sp_waterfall.py -q -m card
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import control, harness, roofline_sp
from portbench.reference import channel
from portbench.reference.codes import code
from portbench.reference.sumproduct import layered_sp, true_llrs
from portbench.trace import Trace

from . import test_card, test_faults
from .test_reference import sha

CELL = "tm8192.sp_ebn0_sweep"
VECTORS = json.loads((Path(__file__).parent / "vectors_sp.json").read_text())
CONFIG = json.loads((Path(__file__).parents[1] / "configs" / "TM8192_SP.json").read_text())


@pytest.mark.parametrize("case", VECTORS["cases"],
                         ids=lambda v: f"{v['code']}-{v['ebn0_db']}x{v['maxiters']}")
def test_decodes(case):
    c = code(case["code"])
    rng = np.random.default_rng(case["seed"])
    data = torch.from_numpy(rng.integers(0, 2, (case["frames"], c.k)).astype(np.uint8))
    noise = torch.from_numpy(rng.standard_normal((case["frames"], c.n)).astype(np.float32))
    sigma = channel.ebn0_sigma(case["ebn0_db"], c.k / c.n)
    cw = channel.encode(c.name, data)
    assert sha(cw.numpy()) == case["codeword_sha256"]
    x = true_llrs(channel.bpsk_awgn(cw, noise, sigma), sigma)
    assert sha(x.numpy()) == case["llrs_sha256"]
    r = layered_sp(c, x, case["maxiters"])
    assert r.success.tolist() == case["success"]
    assert r.iterations.tolist() == case["iterations"]
    assert sha(r.bits.numpy()) == case["bits_sha256"]


def test_roofline_count():
    """28 operations an edge and sweep against the CUDA cores' peak; bytes
    bound only where the sweeps are few."""
    bound, kind = roofline_sp.sumproduct(30720, 8192, 10240, 8192, 8192 * 30)
    assert kind == "ops" and bound == pytest.approx(28 * 30720 * 8192 * 30 / 67e12)
    _, kind = roofline_sp.sumproduct(30720, 8192, 10240, 8192, 1)
    assert kind == "bytes"
    metric = harness.load_metric("sumproduct_roofline_pct.waterfall")
    kernel = "void (anonymous namespace)::sumproduct_kernel<2, 6>(float const*)"
    t = Trace((0.0, 2e5), kernels=[(kernel, 0.0, 1e5), ("other", 1e5, 2e5)])
    counts = {"trials": 8192, "sweeps": 8192 * 30}
    assert metric.read(t, counts, CONFIG) == pytest.approx(100 * bound / 0.1)
    assert metric.read(Trace((0.0, 1.0), kernels=[("other", 0.0, 1.0)]), counts, CONFIG) is None


@pytest.mark.parametrize("fault", ["altered", "half", "unchanged"])
def test_fault_is_caught(fault, monkeypatch):
    test_faults.break_program(monkeypatch, CELL, fault)
    outcome = test_faults.dry(CELL)
    assert not all(c.ok for c in outcome.checks), [(c.name, c.value) for c in outcome.checks]


def test_sound_run_is_correct():
    outcome = test_faults.dry(CELL)
    assert all(c.ok for c in outcome.checks), [(c.name, c.value) for c in outcome.checks]


def test_control_fails(capsys):
    assert control.main(["--workload", CELL, "--control", "bfloat16", "--seeds", "31,32",
                         "--dry-run"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert len(lines) == 2 and not any(x["correct"] for x in lines), lines


@pytest.mark.card
def test_cell_runs_correct_on_card(card):
    test_card.test_cell_runs_correct(CELL, card)


@pytest.mark.card
def test_launches_equal_batches_on_card(card):
    """One `sumproduct_kernel` launch a batch a call drains, at the cell's
    batch: two points of two batches each, after a warm-up call."""
    from labrador_ldpc_tpu_torch.channel.waterfall import waterfall
    from labrador_ldpc_tpu_torch.ops import cuda_sp

    tr = json.loads((Path(__file__).parents[1] / "traffic" / "sp_ebn0_sweep.json").read_text())
    batch = tr["batch"]
    waterfall("TM8192", [1.2], batch=batch, maxiters=100, max_bits=batch * CONFIG["k"],
              noise_model="ebn0", impl=CONFIG["decoder"]["impl"], seed=1, device=card)
    before = cuda_sp.launches
    points = waterfall("TM8192", [0.9, 1.0], batch=batch, maxiters=100,
                       max_bits=2 * batch * CONFIG["k"], noise_model="ebn0",
                       impl=CONFIG["decoder"]["impl"], seed=2, device=card)
    assert cuda_sp.launches - before == sum(pt.trials for pt in points) // batch == 4


@pytest.mark.card
def test_control_counts_wrong_points_on_card(card):
    """The reference with its true LLRs rounded through bfloat16, at the
    cell's sizes: points wrong above 0."""
    lines = test_card._run("portbench.control", "--workload", CELL, "--control", "bfloat16",
                           "--seeds", "161803398", "--seconds", "2")
    assert lines and all(x["checks"]["points_wrong"]["value"] > 0 for x in lines), lines
