"""The port's reference-order decoder, LLR quantizer, int trial step, registry
and CLI against the JAX package, on the CPU.

labrador_ldpc_tpu_torch.ops.minsum.make_ms_decoder (impl "ref") is held to
labrador_ldpc_tpu.ops.minsum.make_ms_decoder in float32, int8, int16 and
int32, int32 with LLRs near the type's limits so that adds and subs
overflow; `quantize_llrs` to JAX's on ties and out-of-range values; the int
trial step's `apply` to the JAX encode -> quantize -> decoder chain on the
same numpy data and noise. Tolerance: exact.
"""

import contextlib
import io
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from labrador_ldpc_tpu.__main__ import main as jmain
from labrador_ldpc_tpu.channel import awgn as jawgn
from labrador_ldpc_tpu.channel import hard as jhard
from labrador_ldpc_tpu.codes.params import ALL_CODES
from labrador_ldpc_tpu.ops import minsum as jminsum
from labrador_ldpc_tpu.ops import qc_minsum as jqc
from labrador_ldpc_tpu.ops.encoder import encode_bits as jencode_bits

import labrador_ldpc_tpu_torch as T
from labrador_ldpc_tpu_torch.__main__ import main as tmain
from labrador_ldpc_tpu_torch.channel.awgn import make_trial_step, resolve_impl
from labrador_ldpc_tpu_torch.ops import cuda_layered, cuda_qc
from test_torch_int import int_llrs
from test_torch_layered import (  # noqa: F401  (one_torch_thread: autouse fixture)
    PARTIAL_EBN0,
    assert_same,
    noisy_llrs,
    one_torch_thread,
)

NAMES = [c.value for c in ALL_CODES]
JDTYPES = {torch.float32: jnp.float32, torch.int8: jnp.int8, torch.int16: jnp.int16,
           torch.int32: jnp.int32}


def ref_llrs(name, dtype, seed):
    """16 rows of `dtype`: float32 noisy rows near the waterfall with two
    clean ones; int8/int16 as tests/test_torch_int.py; int32 quantized at
    2^24 (|llr| up to ~2^27, so a check's sums overflow) with two rows of
    uniform values over the whole int32 range."""
    if dtype in (torch.int8, torch.int16):
        return int_llrs(name, dtype, seed)
    soft = noisy_llrs(name, 16, PARTIAL_EBN0[name], seed)
    soft[:2] = np.sign(noisy_llrs(name, 2, 100.0, seed + 1))
    if dtype == torch.float32:
        return soft
    q = np.round(soft.astype(np.float64) * 2.0**24).astype(np.int64)
    q[2:4] = np.random.default_rng(seed + 2).integers(-(2**31), 2**31, (2, q.shape[1]))
    return np.clip(q, -(2**31), 2**31 - 1).astype(np.int32)


@pytest.mark.parametrize("dtype", list(JDTYPES), ids=["f32", "i8", "i16", "i32"])
@pytest.mark.parametrize("name", NAMES)
def test_ref_matches_jax(name, dtype):
    llrs = ref_llrs(name, dtype, seed=200 + NAMES.index(name))
    ref = jminsum.make_ms_decoder(name, JDTYPES[dtype], maxiters=12)(jnp.asarray(llrs))
    port = T.make_ms_decoder(name, 12, device="cpu")(torch.from_numpy(llrs))
    assert_same(port, ref)
    assert bool(port.success[:2].all()) and not bool(port.success.all())


@pytest.mark.parametrize(
    "name,dtype,kwargs",
    [("TM2048", torch.float32, dict(maxiters=12, alpha=0.8)),
     ("TM1536", torch.int32, dict(maxiters=1)),
     ("TM5120", torch.int8, dict(maxiters=0)),
     ("TC512", torch.float32, dict(maxiters=0))],
)
def test_ref_matches_jax_variants(name, dtype, kwargs):
    """alpha, one iteration, and no iteration (whose bits are the hard
    decisions of the input LLRs in the reference order decoder)."""
    llrs = ref_llrs(name, dtype, seed=9)
    ref = jminsum.make_ms_decoder(name, JDTYPES[dtype], **kwargs)(jnp.asarray(llrs))
    port = T.make_ms_decoder(name, kwargs["maxiters"], kwargs.get("alpha"), device="cpu")(
        torch.from_numpy(llrs))
    assert_same(port, ref)


def test_saturating_helpers_match_jax_at_the_limits():
    """_sat_add/_sat_sub/_sat_abs over every pair of limit values of each int
    dtype (int32 overflow detected on the wrapping add)."""
    from labrador_ldpc_tpu_torch.ops import minsum as tminsum

    for tdt, jdt in ((torch.int8, jnp.int8), (torch.int16, jnp.int16), (torch.int32, jnp.int32)):
        info = torch.iinfo(tdt)
        edge = np.array([info.min, info.min + 1, -2, -1, 0, 1, 2, info.max - 1, info.max],
                        dtype=np.int64)
        a, b = (x.ravel().astype(torch.empty((), dtype=tdt).numpy().dtype)
                for x in np.meshgrid(edge, edge))
        ta, tb = torch.from_numpy(a), torch.from_numpy(b)
        ja, jb = jnp.asarray(a), jnp.asarray(b)
        np.testing.assert_array_equal(tminsum._sat_add(ta, tb).numpy(),
                                      np.asarray(jminsum._sat_add(ja, jb, jdt)))
        np.testing.assert_array_equal(tminsum._sat_sub(ta, tb).numpy(),
                                      np.asarray(jminsum._sat_sub(ja, jb, jdt)))
        np.testing.assert_array_equal(tminsum._sat_abs(ta).numpy(),
                                      np.asarray(jminsum._sat_abs(ja, jdt)))


def test_ref_refuses_what_it_does_not_take():
    dec = T.make_ms_decoder("TC128", 5, alpha=0.8, device="cpu")
    with pytest.raises(ValueError, match="alpha"):
        dec(torch.zeros((2, 128), dtype=torch.int32))
    # float64 and bfloat16 decode (zero LLRs satisfy every check at once);
    # a dtype outside DecodeFrom's does not
    for dtype in (torch.float64, torch.bfloat16):
        dec = T.make_ms_decoder("TC128", 5, device="cpu")
        assert dec(torch.zeros((2, 128), dtype=dtype)).success.all()
    with pytest.raises(ValueError, match="takes float32/bfloat16/float64/int8/int16/int32"):
        T.make_ms_decoder("TC128", 5, device="cpu")(torch.zeros((2, 128), dtype=torch.uint8))
    with pytest.raises(ValueError, match=r"\(B, 128\)"):
        T.make_ms_decoder("TC128", 5, device="cpu")(torch.zeros((2, 127)))


@pytest.mark.parametrize("dtype", [torch.int8, torch.int16], ids=["i8", "i16"])
def test_quantize_llrs_matches_jax(dtype):
    """Half-way ties round to even, values beyond the range clip, default
    scales 16 and 256, and an explicit scale."""
    jdt = JDTYPES[dtype]
    assert T.default_llr_scale(dtype) == jawgn.default_llr_scale(jdt)
    ties = (np.arange(-600, 600, dtype=np.float32) + 0.5) / np.float32(T.default_llr_scale(dtype))
    far = np.array([-1e9, -3e3, -130.0, 130.0, 3e3, 1e9, np.inf, -np.inf], dtype=np.float32)
    noisy = np.random.default_rng(1).standard_normal(4096).astype(np.float32) * 4
    for x in (ties, far, noisy):
        for scale in (None, 3.0):
            got = T.quantize_llrs(torch.from_numpy(x), dtype, scale)
            want = np.asarray(jawgn.quantize_llrs(jnp.asarray(x), jdt, scale))
            assert got.dtype == dtype
            np.testing.assert_array_equal(got.numpy(), want)
    info = torch.iinfo(dtype)
    assert T.quantize_llrs(torch.tensor([1e9, -1e9]), dtype).tolist() == [info.max, info.min]
    with pytest.raises(ValueError, match="int8 or int16"):
        T.quantize_llrs(torch.zeros(3), torch.int32, 1.0)
    with pytest.raises(ValueError, match="no default"):
        T.default_llr_scale(torch.float32)


def _jax_decoder(name, dtype, impl, maxiters):
    if impl == "ref":
        return jminsum.make_ms_decoder(name, JDTYPES[dtype], maxiters=maxiters)
    if impl == "layered":
        return jqc.make_ms_decoder_layered(name, JDTYPES[dtype], maxiters=maxiters)
    return jqc.make_ms_decoder_qc_int(name, JDTYPES[dtype], maxiters=maxiters)


@pytest.mark.parametrize(
    "name,dtype,impl,llr_scale",
    [("TM1280", torch.int8, "layered", None), ("TC256", torch.int16, "qc", None),
     ("TM2048", torch.int8, "cuda_qc", 8.0), ("TC128", torch.int32, "ref", None)],
)
def test_int_trial_step_matches_jax(name, dtype, impl, llr_scale):
    """encode -> BPSK + sigma * noise -> quantize (int32: the JAX package's
    truncating cast) -> decoder -> counters, on shared numpy data and
    noise."""
    code = T.get_code(name)
    ebn0 = PARTIAL_EBN0[name] - (0.5 if impl != "ref" else 0.0)
    sigma = T.noise_sigma(ebn0, code, "ebn0")
    rng = np.random.default_rng(3)
    data = rng.integers(0, 2, (16, code.k), dtype=np.uint8)
    noise = rng.standard_normal((16, code.n)).astype(np.float32)
    step = make_trial_step(name, 16, 12, str(dtype).removeprefix("torch."), impl=impl,
                           llr_scale=llr_scale, device="cpu")
    port = step.apply(data, noise, sigma)

    cw = jencode_bits(name, jnp.asarray(data))
    soft = 1.0 - 2.0 * cw.astype(jnp.float32) + jnp.asarray(noise) * jnp.float32(sigma)
    jdt = JDTYPES[dtype]
    llrs = soft.astype(jdt) if dtype == torch.int32 else jawgn.quantize_llrs(soft, jdt, llr_scale)
    res = _jax_decoder(name, dtype, "qc" if impl == "cuda_qc" else impl, 12)(llrs)
    ref = jhard._count_stats(16, code.k, jnp.asarray(data), res)
    got, want = [int(x) for x in port], [int(x) for x in ref]
    assert got == want, (got, want)
    assert got[2] > 0  # frame errors


def test_registry_auto_table():
    for dtype, want in ((torch.float32, "layered"), (torch.int8, "layered"),
                        (torch.int16, "layered"), (torch.int32, "ref")):
        assert resolve_impl("TM8192", dtype, "auto", "cpu") == want
    for impl in ("ref", "qc", "qc_i8", "cuda_qc", "cuda_layered"):
        assert resolve_impl("TM8192", torch.int8, impl, "cpu") == impl
    # the decoder each impl builds, on one int8 batch
    llrs = torch.from_numpy(int_llrs("TC256", torch.int8, seed=4))
    qc = T.decode_ms("TC256", llrs, maxiters=8, impl="qc", device="cpu")
    for impl in ("qc_i8", "cuda_qc"):
        got = T.decode_ms("TC256", llrs, maxiters=8, impl=impl, device="cpu")
        assert all(torch.equal(a, b) for a, b in zip(got, qc))
    lay = T.decode_ms("TC256", llrs, maxiters=8, device="cpu")
    assert not all(torch.equal(a, b) for a, b in zip(lay, qc))  # another schedule
    assert cuda_qc.launches == cuda_layered.launches == 0


@pytest.mark.parametrize(
    "impl,dtype,alpha,match",
    [("pallas_qc", torch.float32, None, "cuda_qc"),
     ("qc_i8", torch.int16, None, "requires dtype torch.int8"),
     ("qc_i16", torch.float32, None, "requires dtype torch.int16"),
     ("cuda_qc", torch.int32, None, "impl='ref'"),
     ("layered", torch.int32, None, "impl='ref'"),
     ("cuda_layered", torch.int8, 0.8, "alpha"),
     ("ref", torch.int16, 0.8, "alpha"),
     ("cuda_qc", torch.float64, None, "float64 goes to impl='layered'"),
     ("sp", torch.float32, 0.8, "does not take alpha")],
)
def test_registry_errors(impl, dtype, alpha, match):
    with pytest.raises(ValueError, match=match):
        T.decode_ms("TC128", torch.zeros((2, 128), dtype=dtype), alpha=alpha, impl=impl,
                    device="cpu")


def _run(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(argv)
    return rc, buf.getvalue()


@pytest.mark.parametrize(
    "bad,jax_refuses",
    [(["--impl", "qc_i8"], True), (["--dtype", "int16", "--impl", "qc_i8"], True),
     (["--dtype", "int8", "--impl", "qc_i16"], True),
     (["--dtype", "int32", "--impl", "layered"], True),
     (["--decoder", "ms_hard", "--impl", "qc_i16"], True),
     (["--dtype", "int32", "--impl", "cuda_qc"], False),
     (["--dtype", "float64", "--impl", "cuda_layered"], False),
     (["--llr-scale", "8"], False), (["--impl", "pallas_qc"], False)],
    ids=lambda v: " ".join(v) if isinstance(v, list) else str(v),
)
def test_cli_refuses_bad_dtype_impl(bad, jax_refuses):
    """The port's CLI refuses what the JAX CLI refuses, and besides the
    dtypes it does not have yet, an --llr-scale it would ignore and the TPU
    kernels' impl names."""
    with pytest.raises(SystemExit) as exc:
        _run(tmain, ["waterfall", "--snrs", "1.0", "--device", "cpu", *bad])
    assert exc.value.code != 0
    if jax_refuses:
        with pytest.raises(SystemExit) as exc:
            _run(jmain, ["waterfall", "--snrs", "1.0", *bad])
        assert exc.value.code != 0


def test_cli_int8_waterfall_and_checkpoint(tmp_path):
    """An int8 flooding sweep on the CPU prints one CSV row and records the
    dtype and the scale in its checkpoint."""
    ck = tmp_path / "int8.ckpt"
    rc, out = _run(tmain, ["waterfall", "--code", "TC128", "--snrs", "2.0", "--batch", "16",
                           "--max-bits", "1", "--noise-model", "ebn0", "--dtype", "int8",
                           "--impl", "cuda_qc", "--llr-scale", "8", "--device", "cpu",
                           "--checkpoint", str(ck)])
    assert rc == 0 and out.startswith("TC128,2.0,16,1024,") and out.count("\n") == 1
    config = json.loads(ck.read_text().splitlines()[0])
    assert (config["dtype_name"], config["llr_scale"], config["impl"]) == ("int8", 8.0, "cuda_qc")
    rc, out = _run(tmain, ["waterfall", "--code", "TC128", "--snrs", "2.0", "--batch", "16",
                           "--max-bits", "1", "--dtype", "int32", "--device", "cpu"])
    assert rc == 0 and out.startswith("TC128,2.0,16,1024,")
