"""The port's host spans (`labrador_ldpc_tpu_torch/utils/tracing.py`), on the
CPU under a CPU-only `torch.profiler`.

Held: without a profiler `span()` is one shared no-op and makes no
`RecordFunction`; under one, a two-point `waterfall` (TC128, batch 16, two
batches a point; min-sum and bit-flip) yields every span of the waterfall
and the trial step, each child inside its parent's interval, one
`ldpc.trial_step` a batch drained and one `ldpc.waterfall.point` a point;
`decode_ms` yields `ldpc.decode_ms` around `ldpc.copy_in` and `ldpc.decode`;
the outputs are the same with the profiler on and off; the CLI's
`--profile` writes a Chrome trace holding the spans. About 5 s alone.
"""

import json

import pytest
import torch

from labrador_ldpc_tpu_torch.__main__ import main as cli
from labrador_ldpc_tpu_torch.channel.waterfall import waterfall
from labrador_ldpc_tpu_torch.ops.minsum import decode_ms
from labrador_ldpc_tpu_torch.utils import tracing
from labrador_ldpc_tpu_torch.utils.tracing import OFF, span

BATCH, POINTS, PER_POINT = 16, 2, 2
# each child span and the span it must lie in
PARENT = {
    "ldpc.waterfall.setup": "ldpc.waterfall",
    "ldpc.waterfall.point": "ldpc.waterfall",
    "ldpc.trial_step": "ldpc.waterfall.point",
    "ldpc.waterfall.drain": "ldpc.waterfall.point",
    "ldpc.draw": "ldpc.trial_step",
    "ldpc.encode": "ldpc.trial_step",
    "ldpc.channel": "ldpc.trial_step",
    "ldpc.decode": "ldpc.trial_step",
    "ldpc.count": "ldpc.trial_step",
}
SWEEPS = {  # decoder: (noise_model, points)
    "ms": ("perftest", [2.0, 3.0]),
    "bf": ("bsc", [0.02, 0.04]),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run PyTorch's CPU ops on one thread (tests/test_torch_layered.py)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def profiled(fn, tmp_path):
    """fn() under a CPU-only profiler: (its result, the ldpc.* host spans as
    (name, start, end) from the profiler's exported Chrome trace, which is
    read many times faster than `prof.events()` is built)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    spans = [(e["name"], e["ts"], e["ts"] + e["dur"])
             for e in json.loads(path.read_text())["traceEvents"]
             if e.get("ph") == "X" and e["name"].startswith("ldpc.")]
    return out, spans


def assert_nested(spans, parent: dict):
    ns = 1e-3  # the trace's times are µs to the ns; their sums may round by less
    for name, s, e in spans:
        if name in parent:
            assert any(p == parent[name] and ps - ns <= s and e <= pe + ns
                       for p, ps, pe in spans), \
                f"{name} ({s}-{e}) lies in no {parent[name]}"


def sweep(decoder: str):
    noise_model, snrs = SWEEPS[decoder]
    return waterfall("TC128", snrs, batch=BATCH, maxiters=10, max_bits=BATCH * 64 * PER_POINT,
                     noise_model=noise_model, decoder=decoder, seed=3, device="cpu")


def test_span_off_is_one_shared_noop(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a RecordFunction was made with no profiler running")

    monkeypatch.setattr(tracing, "_Range", refuse)
    assert not torch.autograd._profiler_enabled()
    assert span("ldpc.x") is OFF and span("ldpc.y", "batch", 1) is OFF
    with span("ldpc.x"), span("ldpc.y"):
        pass
    assert tracing.spanned("ldpc.z")(lambda a: a + 1)(1) == 2


def test_span_on_is_a_profiler_range(tmp_path):
    def body():
        with span("ldpc.x", "batch", 3):
            assert span("ldpc.y") is not OFF
            return tracing.spanned("ldpc.z")(lambda: 5)()

    out, spans = profiled(body, tmp_path)
    assert out == 5 and sorted(n for n, *_ in spans) == ["ldpc.x", "ldpc.z"]
    assert_nested(spans, {"ldpc.z": "ldpc.x"})


@pytest.mark.parametrize("decoder", sorted(SWEEPS))
def test_waterfall_spans(decoder, tmp_path):
    points, spans = profiled(lambda: sweep(decoder), tmp_path)
    names = [n for n, *_ in spans]
    assert set(names) == {"ldpc.waterfall", *PARENT}
    assert_nested(spans, PARENT)
    drained = sum(pt.trials for pt in points) // BATCH
    assert drained == POINTS * PER_POINT
    assert names.count("ldpc.trial_step") == drained == names.count("ldpc.waterfall.drain")
    assert names.count("ldpc.waterfall.point") == POINTS == len(points)
    assert names.count("ldpc.waterfall") == names.count("ldpc.waterfall.setup") == 1
    for child in ("ldpc.draw", "ldpc.encode", "ldpc.channel", "ldpc.decode", "ldpc.count"):
        assert names.count(child) == drained


@pytest.mark.parametrize("decoder", sorted(SWEEPS))
def test_waterfall_counters_same_on_and_off(decoder, tmp_path):
    def counters(points):
        return [(p.snr_db, p.trials, p.bits, p.bit_errors, p.frame_errors, p.decode_failures,
                 p.iterations) for p in points]

    on, _ = profiled(lambda: sweep(decoder), tmp_path)
    assert counters(on) == counters(sweep(decoder))


def test_decode_ms_spans(tmp_path):
    gen = torch.Generator().manual_seed(7)
    llrs = 1.0 + 0.6 * torch.randn((8, 128), generator=gen)

    def decode():
        return decode_ms("TC128", llrs, maxiters=10, device="cpu")

    on, spans = profiled(decode, tmp_path)
    assert sorted(n for n, *_ in spans) == ["ldpc.copy_in", "ldpc.decode", "ldpc.decode_ms"]
    assert_nested(spans, {"ldpc.copy_in": "ldpc.decode_ms", "ldpc.decode": "ldpc.decode_ms"})
    off = decode()
    for a, b in zip(on, off):
        assert torch.equal(a, b)


def test_cli_profile_writes_chrome_trace(tmp_path, capsys):
    assert cli(["waterfall", "--code", "TC128", "--snrs", "2.0", "--batch", str(BATCH),
                "--maxiters", "10", "--max-bits", "1", "--device", "cpu",
                "--profile", str(tmp_path / "traces")]) == 0
    assert capsys.readouterr().out.startswith("TC128,2.0,16,1024,")
    trace = json.loads((tmp_path / "traces" / "waterfall_TC128.json").read_text())
    events = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    assert {"ldpc.waterfall", "ldpc.waterfall.point", "ldpc.trial_step", "ldpc.decode"} <= \
        {e["name"] for e in events}
    assert [e["args"]["batch"] for e in events if e["name"] == "ldpc.trial_step"] == [0]
    assert [e["args"]["snr"] for e in events if e["name"] == "ldpc.waterfall.point"] == ["2.0"]
