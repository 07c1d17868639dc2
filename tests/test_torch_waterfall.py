"""The port's waterfall, its checkpoint and its CLI against the JAX package,
on the CPU.

`torch.Generator` does not reproduce `jax.random`, so a sweep is held to
itself (the same seed gives the same counters, a resumed checkpoint those
of an uninterrupted run) and to the stored curves statistically (BAND of
tests/test_ber_regression.py); a JAX checkpoint is refused, not resumed;
`SnrPoint.csv` and `info` print what the JAX package prints. The trial
steps a sweep runs: tests/test_torch_channel.py.
"""

import contextlib
import io
import json

import pytest

from labrador_ldpc_tpu.__main__ import main as jmain
from labrador_ldpc_tpu.channel.waterfall import SnrPoint as JSnrPoint
from labrador_ldpc_tpu.channel.waterfall import waterfall as jwaterfall

import labrador_ldpc_tpu_torch as T
from labrador_ldpc_tpu_torch.__main__ import main as tmain
from labrador_ldpc_tpu_torch.ops import cuda_bf, cuda_layered
from test_ber_regression import BAND, _bf_curve_rows
from test_torch_layered import one_torch_thread  # noqa: F401  (autouse fixture)


def test_snrpoint_csv_matches_jax():
    counts = dict(trials=8192, bits=8192 * 4096, bit_errors=1053, frame_errors=78,
                  decode_failures=77, iterations=12345, elapsed_s=1.5)
    for snr in (0.006, 1.0, 2.25):
        port, ref = T.SnrPoint("TM8192", snr, **counts), JSnrPoint("TM8192", snr, **counts)
        assert port.csv() == ref.csv()
        assert (port.ber, port.fer) == (ref.ber, ref.fer)
    assert T.SnrPoint("TC128", 1.0).csv() == JSnrPoint("TC128", 1.0).csv()


def test_waterfall_is_seed_deterministic():
    kw = dict(batch=64, maxiters=30, max_bits=64 * 256 * 2, max_bit_errors=10**9,
              noise_model="bsc", decoder="bf", device="cpu")
    a = T.waterfall("TC512", [0.02, 0.05], seed=5, **kw)
    b = T.waterfall("TC512", [0.02, 0.05], seed=5, **kw)
    c = T.waterfall("TC512", [0.02, 0.05], seed=6, **kw)
    key = lambda pts: [(p.trials, p.bit_errors, p.frame_errors, p.iterations) for p in pts]  # noqa: E731
    assert key(a) == key(b) != key(c)
    assert a[0].trials == 128 and a[1].frame_errors > a[0].frame_errors


def test_waterfall_checkpoint_resume(tmp_path):
    """A sweep resumed from a truncated checkpoint gives the counters of an
    uninterrupted run; a finished one recomputes nothing; other parameters
    are refused."""
    kw = dict(batch=32, maxiters=20, max_bits=32 * 64 * 3, max_bit_errors=10**9, seed=5,
              pipeline_depth=2, noise_model="bsc", decoder="bf", device="cpu")
    ref = T.waterfall("TC128", [0.03, 0.06], **kw)
    ck = tmp_path / "sweep.ckpt"
    T.waterfall("TC128", [0.03, 0.06], checkpoint=str(ck), **kw)
    lines = ck.read_text().splitlines()
    assert len(lines) == 1 + 2 * 4  # config + (3 partial + 1 done) per point
    assert json.loads(lines[0])["rng"] == "torch-cpu"
    ck.write_text("\n".join(lines[:6]) + "\n")  # interrupted inside the second point
    resumed = T.waterfall("TC128", [0.03, 0.06], checkpoint=str(ck), **kw)
    key = lambda pts: [(p.trials, p.bits, p.bit_errors, p.frame_errors, p.iterations) for p in pts]  # noqa: E731
    assert key(resumed) == key(ref)
    again = T.waterfall("TC128", [0.03, 0.06], checkpoint=str(ck), **kw)
    assert key(again) == key(ref)
    with pytest.raises(ValueError, match="different"):
        T.waterfall("TC128", [0.03], checkpoint=str(ck), **{**kw, "maxiters": 10})


def test_waterfall_refuses_a_jax_checkpoint(tmp_path):
    """A checkpoint written by the JAX package's waterfall has the same
    parameters but another random stream: refused, not resumed."""
    ck = tmp_path / "jax.ckpt"
    kw = dict(batch=32, maxiters=10, max_bits=32 * 64, max_bit_errors=10**9, seed=3)
    jwaterfall("TC128", [2.0], checkpoint=str(ck), **kw)
    with pytest.raises(ValueError, match="rng"):
        T.waterfall("TC128", [2.0], checkpoint=str(ck), device="cpu", **kw)


def _stdout(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(argv)
    return rc, buf.getvalue()


def test_cli_info_matches_jax():
    assert _stdout(tmain, ["info"]) == _stdout(jmain, ["info"])


def test_cli_waterfall():
    """--help parses and names --device; a one-batch bf sweep on the CPU
    prints one perftest CSV row; bad flag combinations exit."""
    with pytest.raises(SystemExit) as exc:
        _stdout(tmain, ["waterfall", "--help"])
    assert exc.value.code == 0
    rc, out = _stdout(tmain, ["waterfall", "--decoder", "bf", "--noise-model", "bsc",
                              "--code", "TC128", "--snrs", "0.02", "--batch", "32",
                              "--max-bits", "1", "--device", "cpu"])
    assert rc == 0 and out.startswith("TC128,0.02,32,2048,") and out.count("\n") == 1
    for bad in (["--decoder", "bf", "--impl", "layered"], ["--noise-model", "bsc"],
                ["--decoder", "ms_hard", "--noise-model", "bec"],
                ["--decoder", "bf", "--alpha", "0.8"], ["--impl", "pallas_layered"]):
        with pytest.raises(SystemExit) as exc:
            _stdout(tmain, ["waterfall", "--snrs", "0.01", "--device", "cpu", *bad])
        assert exc.value.code != 0


def test_bf_ber_anchor_bsc():
    """The port's bit-flip decoder on the TC512 BSC(p=0.03) point of the
    stored curve (measured with the TPU kernels, seed 0, batch 8192), at
    4096 trials with its own stream: frame errors within BAND of the stored
    rate, as tests/test_ber_regression.py holds the JAX package."""
    a = _bf_curve_rows()[("TC512", 0.03)]
    expected_fe = a["frame_errors"] / a["trials"] * 4096
    (pt,) = T.waterfall("TC512", [0.03], batch=4096, maxiters=50, max_bits=1,
                        max_bit_errors=10**9, noise_model="bsc", decoder="bf", impl="qc",
                        seed=1, device="cpu")
    assert pt.trials == 4096
    assert expected_fe / BAND <= pt.frame_errors <= expected_fe * BAND, (pt.frame_errors, expected_fe)


def test_cpu_waterfall_launches_no_kernel():
    (pt,) = T.waterfall("TM1280", [0.01], batch=32, maxiters=20, max_bits=1,
                        noise_model="bsc", decoder="bf", device="cpu")
    assert pt.trials == 32
    assert cuda_bf.launches == 0 and cuda_layered.launches == 0
