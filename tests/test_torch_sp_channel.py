"""The port's sum-product decoders through its registry, trial step,
waterfall and CLI against the JAX package, on the CPU.

The registry builds "sp", "sp_layered" and "cuda_sp" (the kernel's wrapper
runs its plain version here) and refuses what the JAX registry refuses, in
its wording; the hard-input surface refuses sum-product; the trial step's
true LLRs 2y/sigma^2 are JAX's bit for bit and its counters JAX's within the
decoder tolerance of tests/test_torch_sumproduct.py; a small waterfall and
the CLI run and count.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from labrador_ldpc_tpu.__main__ import main as jmain
from labrador_ldpc_tpu.channel import hard as jhard
from labrador_ldpc_tpu.channel.awgn import _make_decoder as jmake_decoder
from labrador_ldpc_tpu.ops.encoder import encode_bits as jencode_bits

import labrador_ldpc_tpu_torch as T
from labrador_ldpc_tpu_torch.__main__ import main as tmain
from labrador_ldpc_tpu_torch.channel.awgn import SP_IMPLS, make_trial_step, resolve_impl
from labrador_ldpc_tpu_torch.channel.hard import make_ms_hard_trial_step
from labrador_ldpc_tpu_torch.ops import cuda_sp
from test_torch_layered import one_torch_thread  # noqa: F401  (autouse fixture)
from test_torch_registry import _run
from test_torch_sumproduct import MAXITERS, mixed_llrs


def test_registry_builds_sp_impls():
    """sp, sp_layered and cuda_sp build on the CPU; sp_layered and cuda_sp are
    the kernel's wrapper (its plain version here); "auto" picks none of them."""
    llrs = torch.from_numpy(mixed_llrs("TC256", seed=2))
    res = {impl: T.decode_ms("TC256", llrs, maxiters=8, impl=impl, device="cpu")
           for impl in SP_IMPLS}
    layered = T.make_sp_decoder_layered("TC256", 8, device="cpu")(llrs)
    flooding = T.make_sp_decoder("TC256", 8, device="cpu")(llrs)
    for impl in ("sp_layered", "cuda_sp"):
        assert all(torch.equal(a, b) for a, b in zip(res[impl], layered))
    assert all(torch.equal(a, b) for a, b in zip(res["sp"], flooding))
    for impl in SP_IMPLS:
        assert resolve_impl("TM8192", torch.float32, impl, "cpu") == impl
    for dtype in (torch.float32, torch.int8, torch.int16, torch.int32):
        assert resolve_impl("TM8192", dtype, "auto", "cpu") not in SP_IMPLS
    assert cuda_sp.launches == 0


@pytest.mark.parametrize(
    "impl,dtype,alpha,match",
    [("sp", torch.int8, None, "supports float32 only"),
     ("sp_layered", torch.bfloat16, None, "supports float32 only"),
     ("cuda_sp", torch.int16, None, "supports float32 only"),
     ("sp", torch.float32, 0.8, "does not take alpha"),
     ("sp_layered", torch.float32, 0.5, "does not take alpha"),
     ("sp_pallas", torch.float32, None, "impl='cuda_sp'")],
)
def test_registry_refuses_like_jax(impl, dtype, alpha, match):
    """The dtype and alpha rules of the JAX registry (awgn.py:169-172), in
    its wording (JAX's name of cuda_sp is sp_pallas); the TPU kernel's name
    points at the CUDA one."""
    with pytest.raises(ValueError, match=match):
        T.decode_ms("TC128", torch.zeros((2, 128), dtype=dtype), alpha=alpha, impl=impl,
                    device="cpu")
    if impl != "sp_pallas":
        with pytest.raises(ValueError, match=match):
            jmake_decoder("TC128", getattr(jnp, str(dtype).removeprefix("torch.")), 10, alpha,
                          "sp_pallas" if impl == "cuda_sp" else impl)


@pytest.mark.parametrize("impl", SP_IMPLS)
def test_ms_hard_refuses_sp(impl):
    """Sum-product on the hard-input surface would decode fixed +-1 LLRs
    (biased curves): refused by the library, waterfall() and the CLI."""
    with pytest.raises(ValueError, match="true channel LLRs"):
        make_ms_hard_trial_step("TC128", 8, impl=impl, device="cpu")
    with pytest.raises(ValueError, match="true channel LLRs"):
        T.waterfall("TC128", [0.05], decoder="ms_hard", noise_model="bsc", impl=impl,
                    device="cpu")
    with pytest.raises(SystemExit) as exc:
        _run(tmain, ["waterfall", "--decoder", "ms_hard", "--impl", impl, "--snrs", "0.05",
                     "--noise-model", "bsc", "--device", "cpu"])
    assert "true channel LLRs" in str(exc.value.code)


@pytest.mark.parametrize(
    "bad", [["--dtype", "int8"], ["--dtype", "bfloat16"], ["--alpha", "0.8"]],
    ids=lambda v: " ".join(v),
)
def test_cli_refuses_sp_dtype_and_alpha(bad):
    with pytest.raises(SystemExit) as exc:
        _run(tmain, ["waterfall", "--impl", "sp_layered", "--snrs", "1.0", "--device", "cpu",
                     *bad])
    assert "sum-product" in str(exc.value.code)
    if bad[0] == "--dtype":  # the JAX CLI refuses the same (__main__.py:63-66)
        with pytest.raises(SystemExit) as exc:
            _run(jmain, ["waterfall", "--impl", "sp_layered", "--snrs", "1.0", *bad])
        assert exc.value.code != 0


@pytest.mark.parametrize("impl", ["sp_layered", "sp"])
def test_sp_trial_step_matches_jax(impl):
    """True LLRs 2y/sigma^2 bit for bit against the JAX package's float32
    arithmetic (awgn.py:344-348), and the counters against its step's chain
    (encode -> the same LLRs -> its twin -> _count_stats) on the same numpy
    data and noise, within the decoder tolerance."""
    name, batch, ebn0 = "TM1280", 32, 2.5
    code = T.get_code(name)
    sigma = T.noise_sigma(ebn0, code, "ebn0")
    rng = np.random.default_rng(5)
    data = rng.integers(0, 2, (batch, code.k), dtype=np.uint8)
    noise = rng.standard_normal((batch, code.n)).astype(np.float32)
    step = make_trial_step(name, batch, MAXITERS, impl=impl, device="cpu")
    assert step.impl == impl

    cw = jencode_bits(name, jnp.asarray(data))
    s = jnp.float32(sigma)
    soft = (1.0 - 2.0 * cw.astype(jnp.float32)) + jnp.asarray(noise) * s
    jllrs = (soft * (2.0 / (s * s))).astype(jnp.float32)
    llrs = step.channel(T.encode_bits(code, data, device="cpu"), torch.from_numpy(noise), sigma)
    assert llrs.dtype == torch.float32
    np.testing.assert_array_equal(llrs.numpy(), np.asarray(jllrs))

    port = step.apply(data, noise, sigma)
    jres = jmake_decoder(name, jnp.float32, MAXITERS, None, impl)(jllrs)
    ref = jhard._count_stats(batch, code.k, jnp.asarray(data), jres)
    got = dict(zip(port._fields, (int(x) for x in port)))
    want = dict(zip(ref._fields, (int(x) for x in ref)))
    assert got["trials"] == want["trials"] == batch
    assert 0 < want["frame_errors"] < batch  # some frames fail
    assert abs(got["frame_errors"] - want["frame_errors"]) <= 1
    assert abs(got["decode_failures"] - want["decode_failures"]) <= 1
    # a frame that flips between success and failure moves the sum by up to maxiters
    assert abs(got["iterations"] - want["iterations"]) <= batch + MAXITERS


def test_sp_waterfall_and_checkpoint(tmp_path):
    """A small sp_layered waterfall on the CPU runs and counts; its checkpoint
    records the resolved impl, so it cannot resume as min-sum."""
    ck = tmp_path / "sp.ckpt"
    kw = dict(batch=32, maxiters=20, max_bits=32 * 64 * 2, max_bit_errors=10**9,
              noise_model="ebn0", seed=1, device="cpu")
    pts = T.waterfall("TC128", [2.0, 4.0], impl="sp_layered", checkpoint=str(ck), **kw)
    assert [p.trials for p in pts] == [64, 64] and [p.bits for p in pts] == [4096, 4096]
    assert pts[0].frame_errors > pts[1].frame_errors
    assert pts[0].iterations > 0
    assert json.loads(ck.read_text().splitlines()[0])["impl"] == "sp_layered"
    with pytest.raises(ValueError, match="different"):
        T.waterfall("TC128", [2.0, 4.0], checkpoint=str(ck), **kw)  # impl "auto": layered
    assert cuda_sp.launches == 0


def test_cli_sp_waterfall():
    """python -m labrador_ldpc_tpu_torch waterfall --impl sp_layered|sp: one
    CSV row each."""
    for impl in ("sp_layered", "sp"):
        rc, out = _run(tmain, ["waterfall", "--code", "TC128", "--snrs", "2.5", "--batch", "16",
                               "--max-bits", "1", "--noise-model", "ebn0", "--impl", impl,
                               "--device", "cpu"])
        assert rc == 0 and out.startswith("TC128,2.5,16,1024,") and out.count("\n") == 1
