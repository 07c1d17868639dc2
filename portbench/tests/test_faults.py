"""Each cell's judge, on the CPU at the traffic files' dry-run sizes, with
the timed path broken underneath: an answer altered where it is produced,
half of each batch left out (the rest repeated in its place), and a decoder
that returns its input's hard decisions unchanged. Each run must come out
not correct. (The cells run on one chip: no exchange between chips to
leave out.) Also each cell's control, put in the program's place, must come
out not correct; and the untouched dry runs correct."""

import json
from argparse import Namespace

import pytest
import torch

from portbench import control
from portbench.run import measure

CELLS = ["tm8192.stream_f32_1p5db", "tm8192.stream_i8_1p5db", "tc512.perftest_sweep",
         "tm8192.bf_bsc_sweep"]
CONTROLS = {"tm8192.stream_f32_1p5db": "bfloat16", "tm8192.stream_i8_1p5db": "int4",
            "tc512.perftest_sweep": "bfloat16", "tm8192.bf_bsc_sweep": "encoder_bfloat16"}


def altered(res, x):
    bits = res.bits.clone()
    bits[:, 0] ^= 1
    return res._replace(bits=bits)


def unchanged(res, x):
    x = torch.as_tensor(x)
    hard = (x < 0) if x.dtype.is_floating_point or x.dtype == torch.int8 else x.bool()
    bits = torch.zeros_like(res.bits)
    bits[:, :x.shape[1]] = hard.to(torch.uint8)
    return res._replace(success=torch.ones_like(res.success),
                        iterations=torch.zeros_like(res.iterations), bits=bits)


FAULTS = {"altered": altered, "unchanged": unchanged}


def broken(decode, fault):
    def run(x, *args, **kwargs):
        x = torch.as_tensor(x)
        if fault == "half":
            h = x.shape[0] // 2
            r = decode(x[:h], *args, **kwargs)

            def rep(t):
                return torch.cat([t, t[:x.shape[0] - h]])

            return r._replace(success=rep(r.success), iterations=rep(r.iterations),
                              bits=rep(r.bits))
        return FAULTS[fault](decode(x, *args, **kwargs), x)

    return run


def break_program(monkeypatch, cell, fault):
    """Break the decoder the cell's timed path calls: `decode_ms` for a
    stream, the decoder a waterfall's trial step builds otherwise (patching
    both would break a stream twice: `decode_ms` builds through the same
    maker)."""
    from labrador_ldpc_tpu_torch.channel import awgn, hard
    from labrador_ldpc_tpu_torch.ops import minsum

    if ".stream" in cell:
        real_ms = minsum.decode_ms

        def decode_ms(code, llrs, **kwargs):
            return broken(lambda x: real_ms(code, x, **kwargs), fault)(llrs)

        monkeypatch.setattr(minsum, "decode_ms", decode_ms)
        return
    make_ms, make_bf = awgn._make_decoder, hard._make_bf_decoder
    monkeypatch.setattr(awgn, "_make_decoder", lambda *a, **k: broken(make_ms(*a, **k), fault))
    monkeypatch.setattr(hard, "_make_bf_decoder", lambda *a, **k: broken(make_bf(*a, **k), fault))


def dry(cell, seed=21):
    args = Namespace(workload=cell, seed=seed, seconds=1.0, trace=0, dry_run=True)
    return measure(args)[1]


@pytest.mark.parametrize("fault", ["altered", "half", "unchanged"])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_caught(cell, fault, monkeypatch):
    break_program(monkeypatch, cell, fault)
    outcome = dry(cell)
    assert not all(c.ok for c in outcome.checks), [(c.name, c.value) for c in outcome.checks]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    outcome = dry(cell)
    assert all(c.ok for c in outcome.checks), [(c.name, c.value) for c in outcome.checks]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(cell, capsys):
    assert control.main(["--workload", cell, "--control", CONTROLS[cell], "--seeds", "31,32",
                         "--dry-run"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert len(lines) == 2 and not any(x["correct"] for x in lines), lines
