"""The port's trial steps and their registry against the JAX package, on the
CPU.

The trial steps' pure part (`TrialStep.apply`) is fed numpy-made data bits
and channel noise; the JAX side runs encode_bits -> the same channel
arithmetic -> its twin decoder -> channel.hard._count_stats on the same
arrays. Tolerance: exact (integer counters of bit-exact decoders). The
waterfall that drives these steps, its checkpoint and its CLI:
tests/test_torch_waterfall.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from labrador_ldpc_tpu.channel import hard as jhard
from labrador_ldpc_tpu.ops.bitflip import make_bf_decoder_qc as jbf_qc
from labrador_ldpc_tpu.ops.encoder import encode_bits as jencode_bits
from labrador_ldpc_tpu.ops.qc_minsum import make_ms_decoder_layered as jlayered

import labrador_ldpc_tpu_torch as T
from labrador_ldpc_tpu_torch.channel.awgn import make_trial_step
from labrador_ldpc_tpu_torch.channel.hard import make_bf_trial_step, make_ms_hard_trial_step
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
