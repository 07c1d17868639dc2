"""The entry points' per-layer metrics (`portbench/spans.py` and the five
readers of the program's host spans) on made-up traces of known answer, and
a dry-run-sized waterfall and stream under a CPU-only profiler, whose trace
holds the spans these readers look for."""

import contextlib
import json
import tempfile
from pathlib import Path

import pytest

from portbench import harness, run
from portbench import trace as trace_mod
from portbench.spans import SYNC_CALLS, inside, spans
from portbench.trace import WINDOW, Trace

WATERFALL = ("step_sync_ms.waterfall", "step_enqueue_ms.waterfall", "drain_wait_ms.waterfall",
             "transition_idle_pct.waterfall")
STREAM = ("copy_wait_ms.stream",)


def read(name, t):
    return harness.load_metric(name).read(t, {}, {})


def made_up_waterfall():
    """Window 100-1100 µs. Two steps wholly inside (300 µs with 200 of sync,
    which a cudaMemcpyAsync beside it does not add to; 100 µs with two syncs
    of 10 overlapping by 5), and one cut by the window's start; a sync
    outside every step; two drains inside, one cut by the end. Kernels leave
    the gaps 100-150, 500-560 (two point ends), 700-720 (none), 900-1100
    (one, the other end lies after the window)."""
    host = [
        ("ldpc.trial_step", 50.0, 160.0),  # cut by the window's start
        ("cudaStreamSynchronize", 60.0, 150.0),
        ("ldpc.trial_step", 160.0, 460.0),
        ("ldpc.encode", 170.0, 200.0),
        ("cudaMemcpyAsync", 210.0, 240.0),
        ("cudaStreamSynchronize", 240.0, 440.0),
        ("ldpc.trial_step", 600.0, 700.0),
        ("cudaEventSynchronize", 610.0, 620.0),
        ("cudaMemcpy", 615.0, 625.0),
        ("cudaDeviceSynchronize", 800.0, 850.0),  # in no step
        ("ldpc.waterfall.drain", 460.0, 470.0),
        ("ldpc.waterfall.drain", 700.0, 730.0),
        ("ldpc.waterfall.drain", 1090.0, 1200.0),  # cut by the window's end
        ("ldpc.waterfall.point", 110.0, 510.0),
        ("ldpc.waterfall.point", 515.0, 550.0),
        ("ldpc.waterfall.point", 560.0, 950.0),
        ("ldpc.waterfall.point", 960.0, 1150.0),  # ends after the window
    ]
    kernels = [("k", 150.0, 500.0), ("k", 560.0, 700.0), ("k", 720.0, 900.0)]
    return Trace((100.0, 1100.0), kernels=kernels, host=host)


def test_spans_inside_the_window():
    t = made_up_waterfall()
    assert spans(t, "ldpc.trial_step") == [(160.0, 460.0), (600.0, 700.0)]
    assert spans(t, "ldpc.waterfall.drain") == [(460.0, 470.0), (700.0, 730.0)]
    assert spans(t, "absent") == []
    calls = spans(t, SYNC_CALLS)
    assert inside(calls, (160.0, 460.0)) == [(240.0, 440.0)]
    assert inside(calls, (600.0, 700.0)) == [(610.0, 620.0), (615.0, 625.0)]


def test_waterfall_readers():
    t = made_up_waterfall()
    got = {m: read(m, t) for m in WATERFALL}
    # step syncs: 200 and 15 (10 + 10 overlapping by 5)
    assert got["step_sync_ms.waterfall"] == pytest.approx((200 + 15) / 2 / 1e3)
    assert got["step_enqueue_ms.waterfall"] == pytest.approx((100 + 85) / 2 / 1e3)
    assert got["drain_wait_ms.waterfall"] == pytest.approx((10 + 30) / 2 / 1e3)
    # the gap 500-560 holds two point ends and counts once; 900-1100 holds one
    assert got["transition_idle_pct.waterfall"] == pytest.approx(100 * (60 + 200) / 1000)


def test_copy_wait_reader():
    host = [("ldpc.decode_ms", 0.0, 90.0), ("ldpc.copy_in", 5.0, 85.0),  # cut by the start
            ("ldpc.decode_ms", 100.0, 400.0), ("ldpc.copy_in", 110.0, 170.0),
            ("ldpc.decode", 170.0, 390.0), ("ldpc.copy_in", 500.0, 540.0)]
    t = Trace((10.0, 1000.0), kernels=[("k", 0.0, 1.0)], host=host)
    assert read("copy_wait_ms.stream", t) == pytest.approx((60 + 40) / 2 / 1e3)


@pytest.mark.parametrize("metric", WATERFALL + STREAM)
def test_readers_none_without_spans(metric):
    """A trace of a program that opens no span (the benchmark's traced run
    over the parent) gives no value, and raises nothing."""
    t = Trace((0.0, 1000.0), kernels=[("k", 0.0, 10.0)],
              host=[("aten::copy_", 1.0, 5.0), ("cudaStreamSynchronize", 5.0, 9.0)])
    assert read(metric, t) is None


class _Holder:
    trace = None


@contextlib.contextmanager
def cpu_profiled(device):
    """`trace.profiled` on the CPU: host activity only, no kernel to require;
    the events read from the exported Chrome trace (µs, as `prof.events()`
    gives them, and many times faster to read)."""
    import torch

    holder = _Holder()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(WINDOW):
            yield holder
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    window, host = None, []
    for e in events:
        if e.get("ph") != "X":
            continue
        rec = (e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
        if e["name"] == WINDOW:
            window = rec[1:]
        else:
            host.append(rec)
    holder.trace = Trace(window, host=host)


@pytest.mark.parametrize("cell,metrics", [("tc512.perftest_sweep", WATERFALL),
                                          ("tm8192.stream_i8_1p5db", STREAM)])
def test_dry_run_trace_holds_the_spans(cell, metrics, monkeypatch):
    """A dry-run-sized cell traced on the CPU: the program's spans are in the
    window and every new reader of the cell gives a value; the benchmark's
    `portbench.encode_bits` range lies inside the program's `ldpc.encode`."""
    monkeypatch.setattr(trace_mod, "profiled", cpu_profiled)
    args = run.parse(["--workload", cell, "--seed", "2147483659", "--seconds", "1",
                      "--trace", "1", "--dry-run"])
    _, outcome, values, _, _ = run.measure(args)
    assert all(c.ok for c in outcome.checks)
    for m in metrics:
        assert values[m]["value"] >= 0, m
    t = outcome.trace
    if cell == "tc512.perftest_sweep":
        n_steps = len(spans(t, "ldpc.trial_step"))
        assert n_steps == outcome.counts["trials"] // 64 == len(spans(t, "ldpc.waterfall.drain"))
        encodes = spans(t, "ldpc.encode")
        wrapped = spans(t, "portbench.encode_bits")
        assert len(wrapped) == len(encodes) == n_steps
        assert all(inside(wrapped, e) for e in encodes)
    else:
        assert len(spans(t, "ldpc.copy_in")) == outcome.counts["batches"]
