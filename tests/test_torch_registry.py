"""The port's int trial step, decoder registry and CLI against the JAX package,
on the CPU.

The int trial step's `apply` is held to the JAX encode -> quantize ->
decoder chain on the same numpy data and noise; the registry's "auto" table,
the decoder each impl builds and what each refuses; the CLI refuses what the
JAX CLI refuses and runs an int8 sweep that records its dtype and scale in
its checkpoint. Tolerance: exact.
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
    one_torch_thread,
)
from test_torch_ref import JDTYPES


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
