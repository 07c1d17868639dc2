"""The port's sum-product decoders, registry entries and trial step against the
JAX package, on the CPU.

labrador_ldpc_tpu_torch.ops.sumproduct.layered_sp_plain is the plain version
of the layered BP CUDA kernel (csrc/sumproduct.cu); the TPU kernel
labrador_ldpc_tpu/ops/pallas_sp.py:48 is pinned bit-exact to the XLA twin
labrador_ldpc_tpu.ops.sumproduct.make_sp_decoder_layered (tests/test_pallas_sp.py).
Here the port's decoders are held to the JAX twins on the same numpy-made
true LLRs 2y/sigma^2.

PyTorch's CPU exp/log are not XLA's, and phi cancels for small x (1 - e^-x),
so one ulp of exp becomes a large relative error of phi near PHI_EPS: the
decoders are held by decode outcomes, not bit for bit. Tolerances, with what
was measured on all nine codes at maxiters 12:
  * frames the JAX twin converges: identical bits and success, iterations
    within 1 (measured: identical iterations);
  * frames the JAX twin fails: at most 1 more or fewer success in the batch
    (measured: the same, with identical bits);
  * maxiters 0 exact; maxiters 1 identical bits on a clean batch;
  * the trial step's LLRs bit for bit (one IEEE float32 multiply each side).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from labrador_ldpc_tpu.__main__ import main as jmain
from labrador_ldpc_tpu.channel import hard as jhard
from labrador_ldpc_tpu.channel.awgn import _make_decoder as jmake_decoder
from labrador_ldpc_tpu.codes.params import ALL_CODES
from labrador_ldpc_tpu.ops import sumproduct as jsp
from labrador_ldpc_tpu.ops.encoder import encode_bits as jencode_bits

import labrador_ldpc_tpu_torch as T
from labrador_ldpc_tpu_torch.__main__ import main as tmain
from labrador_ldpc_tpu_torch.channel.awgn import SP_IMPLS, make_trial_step, resolve_impl
from labrador_ldpc_tpu_torch.channel.hard import make_ms_hard_trial_step
from labrador_ldpc_tpu_torch.codes.expand import qc_structure
from labrador_ldpc_tpu_torch.ops import cuda_sp, sumproduct as tsp
from test_torch_layered import (  # noqa: F401  (one_torch_thread: autouse fixture)
    PARTIAL_EBN0,
    assert_same,
    one_torch_thread,
)
from test_torch_ref import _run

NAMES = [c.value for c in ALL_CODES]
MAXITERS = 12
DECODERS = {  # kind -> (JAX twin, port)
    "layered": (jsp.make_sp_decoder_layered, T.make_sp_decoder_layered),
    "flooding": (jsp.make_sp_decoder, T.make_sp_decoder),
}


def _true_llrs(name, batch, seed, ebn0_db):
    """numpy data bits and float32 true LLRs 2y/sigma^2 of BPSK over AWGN at
    Eb/N0 (the port's copy of tests/test_pallas_sp.py:16)."""
    code = T.get_code(name)
    sigma = T.noise_sigma(ebn0_db, code, "ebn0")
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 2, (batch, code.k), dtype=np.uint8)
    cw = T.encode_bits(code, data, device="cpu").numpy()
    tx = 1.0 - 2.0 * cw.astype(np.float64)
    soft = (tx + rng.normal(0.0, sigma, tx.shape)).astype(np.float32)
    return data, soft * np.float32(2.0 / sigma**2)


def mixed_llrs(name, seed):
    """12 rows 1 dB above the code's partial-convergence point (most converge
    within 12 iterations) and 4 rows 1 dB below it (they fail)."""
    _, good = _true_llrs(name, 12, seed, PARTIAL_EBN0[name] + 1.0)
    _, bad = _true_llrs(name, 4, seed + 1, PARTIAL_EBN0[name] - 1.0)
    return np.concatenate([good, bad])


def assert_outcomes_close(port, ref):
    """The decode-outcome tolerance of the module docstring."""
    ok = np.asarray(ref.success)
    np.testing.assert_array_equal(port.success.numpy()[ok], True)
    np.testing.assert_array_equal(port.bits.numpy()[ok], np.asarray(ref.bits)[ok])
    d_iter = np.abs(port.iterations.numpy()[ok] - np.asarray(ref.iterations)[ok])
    assert d_iter.max(initial=0) <= 1, d_iter
    assert abs(int(port.success.numpy()[~ok].sum())) <= 1
    assert port.bits.dtype == torch.uint8 and port.success.dtype == torch.bool
    assert port.iterations.dtype == torch.int32


def test_phi_matches_jax():
    """phi over 0, the clamp's edges, a log sweep, PHI_CLIP and above, and
    random |t|. Below x = 1e-3 the error is absolute: 1 - e^-x cancels, so an
    ulp of exp moves phi by about 6e-8 / x (measured 0.0513 at x = 1.16e-6);
    above it relative (measured 1.03e-5) plus 2.4e-7 absolute where phi
    rounds to 0 or an ulp of its argument (measured 2.4e-7)."""
    rng = np.random.default_rng(0)
    x = np.concatenate([
        [0.0, 1e-7, 5e-7, 9.99e-7, tsp.PHI_EPS, 1.01e-6, 2e-6],
        np.logspace(-6, np.log10(tsp.PHI_CLIP), 4000),
        [tsp.PHI_CLIP, 25.5, 30.0, 1e3],
        np.abs(rng.standard_normal(20000) * 5), rng.uniform(0.0, 30.0, 20000),
    ]).astype(np.float32)
    assert (tsp.PHI_EPS, tsp.PHI_CLIP) == (jsp.PHI_EPS, jsp.PHI_CLIP)
    want = np.asarray(jsp._phi(jnp.asarray(x))).astype(np.float64)
    got = tsp._phi(torch.from_numpy(x)).numpy().astype(np.float64)
    assert got.dtype == np.float64 and np.isfinite(got).all()
    small = x < 1e-3
    assert np.abs(got - want)[small].max() <= 0.06
    np.testing.assert_allclose(got[~small], want[~small], rtol=2e-5, atol=2.5e-7)
    # the clamp: everything at or below PHI_EPS is phi(PHI_EPS), at or above
    # PHI_CLIP phi(PHI_CLIP)
    assert len(set(got[x <= tsp.PHI_EPS])) == 1 and len(set(got[x >= tsp.PHI_CLIP])) == 1


@pytest.mark.parametrize("kind", list(DECODERS))
@pytest.mark.parametrize("name", NAMES)
def test_sp_matches_jax_all_codes(name, kind):
    llrs = mixed_llrs(name, seed=30 + NAMES.index(name))
    jmake, tmake = DECODERS[kind]
    ref = jmake(name, MAXITERS)(jnp.asarray(llrs))
    port = tmake(name, MAXITERS, device="cpu")(torch.from_numpy(llrs))
    assert_outcomes_close(port, ref)
    ok = np.asarray(ref.success)
    assert ok[:12].sum() >= 8 and not ok[12:].any()  # a mixed batch
    if kind == "layered":
        # the CUDA kernel's wrapper runs its plain version on the CPU
        wrapped = T.make_sp_decoder_cuda(name, MAXITERS, device="cpu")(torch.from_numpy(llrs))
        plain = tsp.layered_sp_plain(qc_structure(name), torch.from_numpy(llrs), MAXITERS)
        assert all(torch.equal(a, b) for a, b in zip(wrapped, plain))
        assert all(torch.equal(a, b) for a, b in zip(wrapped, port))
        assert cuda_sp.launches == 0


@pytest.mark.parametrize("kind", list(DECODERS))
@pytest.mark.parametrize("name", ["TM8192", "TC256"])
def test_sp_maxiters_edges(name, kind):
    """maxiters=0 exactly as the twins (layered: zero bits; flooding: the
    LLRs' hard decisions); maxiters=1 on a clean batch: identical bits."""
    jmake, tmake = DECODERS[kind]
    llrs = mixed_llrs(name, seed=7)
    port, ref = tmake(name, 0, device="cpu")(torch.from_numpy(llrs)), jmake(name, 0)(llrs)
    assert_same(port, ref)
    assert not port.success.any() and not port.iterations.any()
    assert bool(port.bits.any()) == (kind == "flooding")
    _, clean = _true_llrs(name, 8, 3, 100.0)
    port, ref = tmake(name, 1, device="cpu")(torch.from_numpy(clean)), jmake(name, 1)(clean)
    assert_same(port, ref)
    assert port.success.all()


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
