"""float64 LLRs, the two-stage decoder, and the bfloat16/float64 routes of the
registry, trial step and CLI, against the JAX package (CPU).

float64: the reference-order decoder against the scalar NumPy oracle
(labrador_ldpc_tpu/utils/oracle.py decode_ms, float64 DecodeFrom), and the
layered, flooding and reference-order twins against the JAX twins run under
`jax.enable_x64(True)` (scoped: x64 does not leak to other tests). No kernel
takes float64: "auto" routes it to the plain layered decoder, as the JAX
package does, and the kernel impls refuse it.

Two-stage: `make_two_stage_decoder` against the JAX one on the case of
tests/test_channel.py:54-103 (TC128, fast 2 iterations in bfloat16, rescue 50
in float32), where the fast pass converges every frame, and on the same draw
at noise 0.7, where it fails on 30 of 64 and the rescue runs with "qc", "ref"
and "sp".

Tolerance: bit-exact in bits, success and iterations; the trial step's
counters exactly.
"""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from labrador_ldpc_tpu.channel import awgn as jawgn
from labrador_ldpc_tpu.channel import hard as jhard
from labrador_ldpc_tpu.ops import minsum as jminsum
from labrador_ldpc_tpu.ops import qc_minsum as jqc
from labrador_ldpc_tpu.ops.encoder import encode_bits as jencode_bits
from labrador_ldpc_tpu.utils import oracle

import labrador_ldpc_tpu_torch as T
from labrador_ldpc_tpu_torch.__main__ import main as tmain
from labrador_ldpc_tpu_torch.channel.awgn import make_trial_step, resolve_impl
from test_torch_layered import (  # noqa: F401  (one_torch_thread: autouse fixture)
    PARTIAL_EBN0,
    assert_same,
    one_torch_thread,
)

# kind -> (JAX twin builder, port builder), both (name, dtype, maxiters, alpha)
TWINS = {
    "layered": (jqc.make_ms_decoder_layered,
                lambda name, mi, alpha: T.make_ms_decoder_layered(name, mi, alpha, device="cpu")),
    "qc": (jqc.make_ms_decoder_qc,
           lambda name, mi, alpha: T.make_ms_decoder_qc(name, mi, alpha, device="cpu")),
    "ref": (jminsum.make_ms_decoder,
            lambda name, mi, alpha: T.make_ms_decoder(name, mi, alpha, device="cpu")),
}


def f64_llrs(name, seed, batch=12, n_clean=4):
    """float64 BPSK + AWGN rows near the code's waterfall (noise drawn in
    float64, so the LLRs are not float32 values), the first n_clean clean."""
    code = T.get_code(name)
    rng = np.random.default_rng(seed)
    cw = T.encode_bits(code, rng.integers(0, 2, (batch, code.k), dtype=np.uint8),
                       device="cpu").numpy()
    sigma = T.noise_sigma(PARTIAL_EBN0[name], code, "ebn0")
    llrs = 1.0 - 2.0 * cw + sigma * rng.standard_normal(cw.shape)
    llrs[:n_clean] = 1.0 - 2.0 * cw[:n_clean]
    return llrs


@pytest.mark.parametrize("name", ["TC128", "TC256"])
def test_f64_ref_matches_oracle(name):
    """The scalar oracle decodes one codeword at a time in float64."""
    llrs = f64_llrs(name, seed=7, batch=4, n_clean=1)
    port = T.make_ms_decoder(name, 10, device="cpu")(torch.from_numpy(llrs))
    assert port.bits.dtype == torch.uint8
    for i in range(llrs.shape[0]):
        ok, iters, out = oracle.decode_ms(name, llrs[i], maxiters=10)
        assert (bool(port.success[i]), int(port.iterations[i])) == (ok, iters)
        np.testing.assert_array_equal(T.pack_bits(port.bits[i : i + 1], device="cpu")[0].numpy(),
                                      out)
    assert bool(port.success[0]) and not bool(port.success.all())


@pytest.mark.parametrize("kind", list(TWINS))
@pytest.mark.parametrize("name", ["TC128", "TM1536", "TM2048"])
def test_f64_twin_matches_jax_x64(name, kind):
    llrs = f64_llrs(name, seed=40 + len(name))
    jmake, tmake = TWINS[kind]
    with jax.enable_x64(True):
        ref = jmake(name, jnp.float64, 12, None)(jnp.asarray(llrs, dtype=jnp.float64))
        ref = [np.asarray(x) for x in ref]
    port = tmake(name, 12, None)(torch.from_numpy(llrs))
    assert_same(port, T.MSResult(*ref))
    assert bool(port.success[:4].all()) and not bool(port.success.all())
    assert jnp.asarray(1.0).dtype == jnp.float32  # x64 is off again


def test_f64_twin_matches_jax_x64_alpha():
    llrs = f64_llrs("TM2048", seed=9)
    with jax.enable_x64(True):
        ref = jqc.make_ms_decoder_layered("TM2048", jnp.float64, 12, 0.8)(
            jnp.asarray(llrs, dtype=jnp.float64))
        ref = [np.asarray(x) for x in ref]
    port = T.make_ms_decoder_layered("TM2048", 12, 0.8, device="cpu")(torch.from_numpy(llrs))
    assert_same(port, T.MSResult(*ref))


def two_stage_llrs(sigma=0.55):
    """tests/test_channel.py:60-68: TC128, B=64, noise 0.55 on the +-1 LLRs."""
    c = T.get_code("TC128")
    rng = np.random.default_rng(23)
    data = rng.integers(0, 2, (64, c.k), dtype=np.uint8)
    cw = np.asarray(jencode_bits("TC128", jnp.asarray(data)))
    tx = 1.0 - 2.0 * cw.astype(np.float32)
    return data, tx, tx + np.float32(sigma) * rng.standard_normal(tx.shape).astype(np.float32)


@pytest.mark.parametrize("rescue,sigma", [("qc", 0.55), ("qc", 0.7), ("ref", 0.7), ("sp", 0.7)])
def test_two_stage_matches_jax(rescue, sigma):
    """JAX's defaults (bf16 layered fast pass, float32 rescue) against the
    port's (the kernels' wrappers, their plain versions here); the "sp"
    rescue takes true LLRs, scaled once as the JAX test does."""
    data, _, noisy = two_stage_llrs(sigma)
    llrs = noisy * np.float32(2.0 / sigma**2) if rescue == "sp" else noisy
    ref = jawgn.make_two_stage_decoder("TC128", maxiters_fast=2, maxiters_rescue=50,
                                       rescue_impl=rescue)(jnp.asarray(llrs))
    kw = {} if rescue == "qc" else dict(rescue_impl=rescue)
    port = T.make_two_stage_decoder("TC128", 2, 50, device="cpu", **kw)(torch.from_numpy(llrs))
    assert_same(port, ref)
    fast = T.make_ms_decoder_layered("TC128", 2, device="cpu")(
        torch.from_numpy(llrs).to(torch.bfloat16))
    n_fast, n_two = int(fast.success.sum()), int(port.success.sum())
    if sigma == 0.55:  # the case of tests/test_channel.py: no frame needs a rescue
        assert n_fast == n_two == 64
    else:  # the rescue ran and converged some failed frames
        assert n_fast < n_two < 64
    rescued = ~fast.success
    assert bool((port.iterations[rescued] >= 2).all())  # fast's 2 plus the rescue's
    ok = port.success.numpy()
    assert (port.bits.numpy()[ok, :64] == data[ok]).all()


def test_two_stage_plain_impls_are_the_defaults_on_cpu():
    """fast "layered" + rescue "qc" decode as the default kernel pairing does
    on the CPU, and a batch where the fast pass converges everywhere returns
    the fast result itself."""
    _, tx, noisy = two_stage_llrs()
    x = torch.from_numpy(noisy)
    a = T.make_two_stage_decoder("TC128", 2, 50, device="cpu")(x)
    b = T.make_two_stage_decoder("TC128", 2, 50, fast_impl="layered", rescue_impl="qc",
                                 device="cpu")(x)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    clean = torch.from_numpy(tx[:4])
    fast = T.make_ms_decoder_layered("TC128", 25, device="cpu")(clean.to(torch.bfloat16))
    got = T.make_two_stage_decoder("TC128", device="cpu")(clean)
    assert bool(got.success.all()) and (got.iterations == 0).all()
    assert all(torch.equal(u, v) for u, v in zip(got, fast))
    with pytest.raises(ValueError, match="float64 goes to"):
        T.make_two_stage_decoder("TC128", dtype=torch.float64, device="cpu")


def test_registry_routes_bf16_and_f64():
    for dtype in (torch.bfloat16, torch.float64):
        assert resolve_impl("TM8192", dtype, "auto", "cpu") == "layered"
        for impl in ("ref", "qc", "layered"):
            assert resolve_impl("TM8192", dtype, impl, "cpu") == impl
    # no kernel takes float64: "auto" picks the plain layered decoder on
    # every device (no card is needed to ask)
    assert resolve_impl("TM8192", torch.float64, "auto", "cuda") == "layered"
    x = torch.from_numpy(f64_llrs("TC256", seed=3))
    for dtype in (torch.bfloat16, torch.float64):
        got = T.decode_ms("TC256", x.to(dtype), maxiters=8, device="cpu")
        want = T.make_ms_decoder_layered("TC256", 8, device="cpu")(x.to(dtype))
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    bf = T.decode_ms("TC256", x.to(torch.bfloat16), maxiters=8, impl="cuda_qc", device="cpu")
    qc = T.decode_ms("TC256", x.to(torch.bfloat16), maxiters=8, impl="qc", device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(bf, qc))
    for impl in ("cuda_layered", "cuda_qc"):
        with pytest.raises(ValueError, match="float64 goes to impl='layered'"):
            T.decode_ms("TC256", x, impl=impl, device="cpu")
        with pytest.raises(ValueError, match="float64 LLRs go to impl='layered'"):
            T.make_ms_decoder_cuda_layered("TC256", 8, device="cpu")(x)
    for impl in ("sp", "sp_layered", "cuda_sp"):
        with pytest.raises(ValueError, match="float32 only"):
            T.decode_ms("TC256", x.to(torch.bfloat16), impl=impl, device="cpu")


@pytest.mark.parametrize("dtype_name,impl", [("bfloat16", "auto"), ("bfloat16", "cuda_qc"),
                                             ("float64", "auto"), ("float64", "ref")])
def test_trial_step_matches_jax(dtype_name, impl):
    """encode -> BPSK + sigma * noise in float32 -> cast to the dtype ->
    decoder -> counters, on shared numpy data and noise."""
    code = T.get_code("TM1536")
    sigma = T.noise_sigma(PARTIAL_EBN0["TM1536"] - 0.5, code, "ebn0")
    rng = np.random.default_rng(4)
    data = rng.integers(0, 2, (16, code.k), dtype=np.uint8)
    noise = rng.standard_normal((16, code.n)).astype(np.float32)
    step = make_trial_step("TM1536", 16, 12, dtype_name, impl=impl, device="cpu")
    port = step.apply(data, noise, sigma)
    jimpl = {"auto": "layered", "cuda_qc": "qc"}.get(impl, impl)
    with jax.enable_x64(dtype_name == "float64"):
        cw = jencode_bits("TM1536", jnp.asarray(data))
        soft = 1.0 - 2.0 * cw.astype(jnp.float32) + jnp.asarray(noise) * jnp.float32(sigma)
        jdt = jnp.dtype(dtype_name)
        res = jawgn._make_decoder("TM1536", jdt, 12, None, jimpl)(soft.astype(jdt))
        ref = [int(x) for x in jhard._count_stats(16, code.k, jnp.asarray(data), res)]
    got = [int(x) for x in port]
    assert got == ref, (got, ref)
    assert got[2] > 0  # frame errors


def _stdout(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = tmain(argv)
    return rc, buf.getvalue()


def test_cli_waterfall_bf16_f64():
    for dtype, impl in (("bfloat16", "auto"), ("bfloat16", "cuda_qc"), ("float64", "qc")):
        rc, out = _stdout(["waterfall", "--code", "TC128", "--snrs", "2.0", "--noise-model",
                           "ebn0", "--dtype", dtype, "--impl", impl, "--batch", "32",
                           "--max-bits", "1", "--maxiters", "10", "--device", "cpu"])
        assert rc == 0 and out.startswith("TC128,2.0,32,2048,") and out.count("\n") == 1
    for bad in (["--impl", "cuda_layered"], ["--llr-scale", "8"], ["--impl", "sp"]):
        with pytest.raises(SystemExit) as exc:
            _stdout(["waterfall", "--snrs", "1.0", "--device", "cpu", "--dtype", "float64", *bad])
        assert exc.value.code != 0
