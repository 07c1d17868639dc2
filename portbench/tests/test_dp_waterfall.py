"""The four-card cell `tm8192.dp_waterfall_4chip` on the CPU: its entries
against the contract's rules, its dry run (two Gloo ranks, rank 1 started
by the driver) correct, its judge against faults on rank 0 (one rank's
counters left out of every batch's sum; the decoder broken as
`test_faults.py` breaks it), the staged reference decode against one call,
the judge's cut of batches over the ranks, and the reader of
`collective_wait_pct.dp_waterfall` on made-up traces."""

import json
from argparse import Namespace
from pathlib import Path

import pytest
import torch

from portbench import harness
from portbench.drivers import dp_waterfall
from portbench.reference import channel as ref_channel
from portbench.reference.codes import code as ref_code
from portbench.reference.decoders import layered_minsum
from portbench.run import measure
from portbench.tests.test_faults import break_program
from portbench.trace import Trace

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL = "tm8192.dp_waterfall_4chip"
METRIC = "collective_wait_pct.dp_waterfall"


def test_entries_follow_the_rules():
    cells = {w["name"]: w for w in BENCH["workloads"]}
    four = [w for w in cells.values() if w["chips"] == 4]
    assert all(w["chips"] in (1, 4) for w in cells.values())
    assert len(four) <= max(1, len(cells) // 4) and cells[CELL]["chips"] == 4
    configs = {c["name"]: c for c in BENCH["configs"]}
    cfg = json.loads((ROOT / configs[cells[CELL]["config"]]["file"]).read_text())
    assert cfg["name"] == cells[CELL]["config"] and cfg["reduced"] == []
    assert ref_code(cfg["code"]).k == cfg["k"] and cfg["deployment"]["ranks"] == 4
    cell = harness.find_cell(CELL)
    assert [m["name"] for m in cell.end_to_end] == ["waterfall_trials_per_s", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == [METRIC]
    assert cell.per_layer[0]["layer"] == "data parallelism"
    tr = cell.traffic
    assert tr["ranks"] == 4 and tr["backend"] == "nccl" and tr["batch"] % tr["ranks"] == 0
    assert [c["trials"] // tr["batch"] for c in tr["calls"]] == [1, 1, 2, 16, 96]


def dry(seed=21, control=None):
    args = Namespace(workload=CELL, seed=seed, seconds=1.0, trace=0, dry_run=True)
    if control is None:
        return measure(args)[1]
    ctx = harness.Context(harness.find_cell(CELL), seed, 1.0, False, torch.device("cpu"), True)
    return dp_waterfall.run(ctx, control=control)


def test_sound_dry_run_is_correct():
    outcome = dry()
    assert all(c.ok for c in outcome.checks), [(c.name, c.value) for c in outcome.checks]
    assert [c.name for c in outcome.checks] == ["points_wrong", "ranks_disagreeing"]
    assert outcome.attempted == 24 and outcome.metrics["waterfall_trials_per_s"] > 0


def test_one_rank_left_out_of_the_sum_is_caught():
    outcome = dry(control="drop_rank")
    assert outcome.checks[0].value == 2, [(c.name, c.value) for c in outcome.checks]


@pytest.mark.parametrize("fault", ["altered", "half", "unchanged"])
def test_broken_decoder_on_rank_0_is_caught(fault, monkeypatch):
    break_program(monkeypatch, CELL, fault)
    outcome = dry()
    assert not all(c.ok for c in outcome.checks), [(c.name, c.value) for c in outcome.checks]


def test_parent_without_a_timeout_fails_at_once(monkeypatch):
    """A program whose `initialize` takes no timeout: the cell stops before it
    starts a rank."""
    from labrador_ldpc_tpu_torch.parallel import launch

    def initialize(coordinator_address=None, num_processes=None, process_id=None,
                   backend=None, device="cuda"):
        raise AssertionError("the driver must not join a group")

    monkeypatch.setattr(launch, "initialize", initialize)
    monkeypatch.setattr(dp_waterfall.subprocess, "Popen", None)
    with pytest.raises(SystemExit, match="no timeout"):
        dry()


@pytest.mark.parametrize("snr", [1.0, 2.0, 3.0])
def test_staged_minsum_equals_one_call(snr):
    c = ref_code("TC512")
    gen = torch.Generator().manual_seed(7)
    data, raw = ref_channel.draw(gen, 48, c.k, c.n, "normal", 0.0, torch.device("cpu"))
    sigma = ref_channel.ebn0_sigma(snr, c.k / c.n)
    llrs = ref_channel.bpsk_awgn(ref_channel.encode(c.name, data), raw, sigma)
    want = layered_minsum(c, llrs, 40)
    got = dp_waterfall.staged_minsum(c, llrs, 40, stages=(2, 5, 12))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    if snr == 2.0:  # every stage ran on some frames, and some frames failed
        assert 0 < int((~want.success).sum()) and 12 < int(want.iterations[want.success].max())


def test_judge_runs_cover_each_batch_once():
    kw = {"max_bits": 4 * 8 * 16, "batch": 8}  # four batches of k = 16
    points = [(dict(kw, max_bits=8 * 16), 1, 0, None), (kw, 1, 0, None), (kw, 2, 0, None)]
    runs = dp_waterfall.judge_runs(points, [0, 2], 16, 4)
    assert runs == [[(0, 0, 1), (1, 0, 1)], [(1, 1, 2)], [(1, 3, 1)], []]
    assert dp_waterfall.judge_runs(points, [1], 16, 1) == [[(0, 0, 4)]]


NCCL = "ncclDevKernel_AllReduce_Sum_i32_RING_LL(ncclDevKernelArgsStorage<4096ul>)"
DECODE = "void (anonymous namespace)::layered_minsum_kernel<float, 2>(float const*)"


def made_up(kernels, spans=(("ldpc.all_reduce", 500.0, 510.0),)):
    return Trace((0.0, 1000.0), kernels=kernels, host=list(spans))


def test_collective_wait_reader():
    read = harness.load_metric(METRIC).read
    alone = made_up([(DECODE, 0.0, 500.0), (NCCL, 500.0, 700.0), (DECODE, 700.0, 900.0)])
    assert read(alone, {}, {}) == pytest.approx(20.0)
    # a decode kernel running beside the NCCL kernel: only the rest counts
    overlapped = made_up([(DECODE, 0.0, 600.0), (NCCL, 500.0, 700.0), (DECODE, 650.0, 900.0)])
    assert read(overlapped, {}, {}) == pytest.approx(5.0)
    assert read(made_up(alone.kernels, spans=()), {}, {}) is None
    outside = made_up(alone.kernels, spans=(("ldpc.all_reduce", 900.0, 1100.0),))
    assert read(outside, {}, {}) is None
