"""The port's trial steps, waterfall and CLI against the JAX package, on the CPU.

The trial steps' pure part (`TrialStep.apply`) is fed numpy-made data bits
and channel noise; the JAX side runs encode_bits -> the same channel
arithmetic -> its twin decoder -> channel.hard._count_stats on the same
arrays. Tolerance: exact (integer counters of bit-exact decoders).
`torch.Generator` does not reproduce `jax.random`, so the waterfall itself is
held to the stored curves statistically (BAND of tests/test_ber_regression.py).
"""

import contextlib
import io
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from labrador_ldpc_tpu.__main__ import main as jmain
from labrador_ldpc_tpu.channel import hard as jhard
from labrador_ldpc_tpu.channel.waterfall import SnrPoint as JSnrPoint
from labrador_ldpc_tpu.channel.waterfall import waterfall as jwaterfall
from labrador_ldpc_tpu.ops.bitflip import make_bf_decoder_qc as jbf_qc
from labrador_ldpc_tpu.ops.encoder import encode_bits as jencode_bits
from labrador_ldpc_tpu.ops.qc_minsum import make_ms_decoder_layered as jlayered

import labrador_ldpc_tpu_torch as T
from labrador_ldpc_tpu_torch.__main__ import main as tmain
from labrador_ldpc_tpu_torch.channel.awgn import make_trial_step
from labrador_ldpc_tpu_torch.channel.hard import make_bf_trial_step, make_ms_hard_trial_step
from labrador_ldpc_tpu_torch.ops import cuda_bf, cuda_layered
from test_ber_regression import BAND, _bf_curve_rows
from test_torch_layered import one_torch_thread  # noqa: F401  (autouse fixture)


def _draws(name, batch, channel, param, seed):
    """numpy data bits and the channel's raw noise: a Bernoulli(param) mask
    for bsc/bec, float32 standard normals for the AWGN channels."""
    code = T.get_code(name)
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 2, (batch, code.k), dtype=np.uint8)
    if channel in ("bsc", "bec"):
        return data, rng.random((batch, code.n)) < param
    return data, rng.standard_normal((batch, code.n)).astype(np.float32)


def _jax_channel(channel, cw, noise, param):
    """The JAX package's channel arithmetic (channel/hard.py, channel/awgn.py)
    on the given noise."""
    if channel == "bsc":
        return cw ^ jnp.asarray(noise).astype(jnp.uint8)
    if channel == "bec":
        return cw * (1 - jnp.asarray(noise).astype(jnp.uint8))
    tx = 1.0 - 2.0 * cw.astype(jnp.float32)
    return tx + jnp.asarray(noise) * jnp.float32(param)


def _assert_stats_equal(port, ref):
    got = [int(x) for x in port]
    want = [int(x) for x in ref]
    assert got == want, (got, want)
    return dict(zip(port._fields, got))


@pytest.mark.parametrize(
    "name,channel,param",
    [("TM1280", "bsc", 0.01), ("TC512", "bsc", 0.04), ("TM1280", "bec", 0.02),
     ("TM2048", "ebn0", T.noise_sigma(6.0, T.get_code("TM2048"), "ebn0"))],
)
def test_bf_trial_step_matches_jax(name, channel, param):
    data, noise = _draws(name, 48, channel, param, seed=1)
    step = make_bf_trial_step(name, 48, 30, channel, impl="qc", device="cpu")
    port = step.apply(data, noise, param)
    cw = jencode_bits(name, jnp.asarray(data))
    rx = _jax_channel(channel, cw, noise, param)
    if channel == "ebn0":
        rx = (rx < 0).astype(jnp.uint8)
    ref = jhard._count_stats(48, T.get_code(name).k, jnp.asarray(data), jbf_qc(name, 30)(rx))
    stats = _assert_stats_equal(port, ref)
    assert stats["trials"] == 48 and stats["frame_errors"] > 0


@pytest.mark.parametrize(
    "decoder,name,channel,param",
    [("ms_hard", "TC512", "bsc", 0.08),
     ("ms_hard", "TM1280", "perftest", T.noise_sigma(1.0)),
     ("ms", "TC256", "perftest", T.noise_sigma(1.0))],
)
def test_ms_trial_steps_match_jax(decoder, name, channel, param):
    """Hard-input min-sum (+-1 LLRs of the sliced bits) and the soft step,
    against the JAX layered twin on the same arrays."""
    data, noise = _draws(name, 32, channel, param, seed=2)
    if decoder == "ms":
        step = make_trial_step(name, 32, 30, impl="layered", device="cpu")
    else:
        step = make_ms_hard_trial_step(name, 32, 30, channel, impl="layered", device="cpu")
    port = step.apply(data, noise, param)
    cw = jencode_bits(name, jnp.asarray(data))
    rx = _jax_channel(channel, cw, noise, param)
    if decoder == "ms":
        llrs = rx.astype(jnp.float32)
    else:
        hard = (rx < 0).astype(jnp.uint8) if channel != "bsc" else rx
        llrs = 1.0 - 2.0 * hard.astype(jnp.float32)
    res = jlayered(name, jnp.float32, maxiters=30)(llrs)
    ref = jhard._count_stats(32, T.get_code(name).k, jnp.asarray(data), res)
    stats = _assert_stats_equal(port, ref)
    assert stats["frame_errors"] > 0


def test_trial_step_draw_is_seeded():
    step = make_bf_trial_step("TC128", 16, 10, "bsc", device="cpu")
    a = step(torch.Generator().manual_seed(4), 0.05)
    b = step(torch.Generator().manual_seed(4), 0.05)
    assert [int(x) for x in a] == [int(x) for x in b]
    data, flips = step.draw(torch.Generator().manual_seed(4), 0.05)
    assert data.shape == (16, 64) and flips.shape == (16, 128) and flips.dtype == torch.bool


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


@pytest.mark.parametrize(
    "build,match",
    [
        (lambda: make_trial_step("TC128", 8, dtype_name="float64", impl="cuda_layered",
                                 device="cpu"), "float64 goes to impl='layered'"),
        (lambda: make_trial_step("TC128", 8, dtype_name="bfloat16", llr_scale=16.0, device="cpu"),
         "llr_scale"),
        (lambda: make_trial_step("TC128", 8, dtype_name="int32", impl="layered", device="cpu"),
         "impl='ref'"),
        (lambda: make_trial_step("TC128", 8, llr_scale=16.0, device="cpu"), "llr_scale"),
        (lambda: make_ms_hard_trial_step("TC128", 8, impl="sp_layered", device="cpu"),
         "true channel LLRs"),
        (lambda: make_trial_step("TC128", 8, impl="qc_i16", device="cpu"), "requires dtype"),
        (lambda: make_trial_step("TC128", 8, dtype_name="bfloat16", impl="sp_layered",
                                 device="cpu"), "float32 only"),
        (lambda: make_bf_trial_step("TC128", 8, impl="pallas", device="cpu"), "impl='cuda'"),
        (lambda: make_bf_trial_step("TC128", 8, impl="layered", device="cpu"), "auto|cuda|qc|gather"),
        (lambda: make_bf_trial_step("TC128", 8, channel="nope", device="cpu"), "bsc|bec"),
        (lambda: make_ms_hard_trial_step("TC128", 8, channel="bec", device="cpu"), "bsc|perftest"),
        (lambda: T.waterfall("TC128", [0.01], decoder="ms", noise_model="bsc", device="cpu"),
         "noise_model"),
        (lambda: T.waterfall("TC128", [0.01], decoder="bf", noise_model="bsc", alpha=0.8,
                             device="cpu"), "decoder='ms' only"),
        (lambda: T.waterfall("TC128", [0.01], decoder="sum-product", device="cpu"),
         "ms\\|ms_hard\\|bf"),
    ],
)
def test_registry_rejects_what_this_slice_lacks(build, match):
    with pytest.raises(ValueError, match=match):
        build()


def test_cpu_waterfall_launches_no_kernel():
    (pt,) = T.waterfall("TM1280", [0.01], batch=32, maxiters=20, max_bits=1,
                        noise_model="bsc", decoder="bf", device="cpu")
    assert pt.trials == 32
    assert cuda_bf.launches == 0 and cuda_layered.launches == 0
