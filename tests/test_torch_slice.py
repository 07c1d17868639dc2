"""The slice end to end on the CPU: the serving pipeline of bench.py:57-77
through the port's entry points, against the JAX package's, and the entry
points' device and registry rules."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import labrador_ldpc_tpu as J
from labrador_ldpc_tpu.channel.awgn import quantize_llrs as jquantize_llrs

import labrador_ldpc_tpu_torch as T
from labrador_ldpc_tpu_torch.channel.awgn import make_trial_step
from labrador_ldpc_tpu_torch.channel.hard import make_bf_trial_step, make_ms_hard_trial_step
from labrador_ldpc_tpu_torch.ops import cuda_layered
from test_torch_layered import one_torch_thread  # noqa: F401  (autouse fixture)

FLIPS = (1 << 7) | (1 << 5) | (1 << 3)  # 3 bits of byte 0 (benches/decode.rs:52)


def test_tm8192_serving_pipeline_matches_jax():
    """bytes -> encode -> 3 flips -> hard_to_llrs f32 -> decode_ms, B=16."""
    code = T.LDPCCode.TM8192
    data = np.random.default_rng(0).integers(0, 256, (16, code.k // 8), dtype=np.uint8)

    cw = T.encode(code, data, device="cpu")
    cw[:, 0] ^= FLIPS
    llrs = T.hard_to_llrs(cw, torch.float32, device="cpu")
    res = T.decode_ms(code, llrs, maxiters=50, device="cpu")

    jcw = np.array(J.encode(J.LDPCCode.TM8192, jnp.asarray(data)))
    jcw[:, 0] ^= FLIPS
    jres = J.decode_ms(J.LDPCCode.TM8192, J.hard_to_llrs(jnp.asarray(jcw), jnp.float32),
                       maxiters=50)

    np.testing.assert_array_equal(cw.numpy(), jcw)
    np.testing.assert_array_equal(res.bits.numpy(), np.asarray(jres.bits))
    np.testing.assert_array_equal(res.success.numpy(), np.asarray(jres.success))
    np.testing.assert_array_equal(res.iterations.numpy(), np.asarray(jres.iterations))
    assert res.success.all()
    np.testing.assert_array_equal(T.pack_bits(res.bits[:, : code.k], device="cpu").numpy(), data)
    assert cuda_layered.launches == 0  # the CPU path never launches the kernel


def test_tm8192_decode_bf_pipeline_matches_jax():
    """The hard-decision slice: bytes -> encode -> 3 flips in byte 0 ->
    unpack -> decode_bf (the protocol of benches/decode.rs:22-37), B=16."""
    code = T.LDPCCode.TM8192
    data = np.random.default_rng(1).integers(0, 256, (16, code.k // 8), dtype=np.uint8)
    cw = T.encode(code, data, device="cpu")
    cw[:, 0] ^= FLIPS
    res = T.decode_bf(code, T.unpack_bits(cw, device="cpu"), maxiters=50, device="cpu")

    jcw = np.array(J.encode(J.LDPCCode.TM8192, jnp.asarray(data)))
    jcw[:, 0] ^= FLIPS
    jres = J.decode_bf(J.LDPCCode.TM8192, J.unpack_bits(jnp.asarray(jcw)), maxiters=50)

    np.testing.assert_array_equal(res.bits.numpy(), np.asarray(jres.bits))
    np.testing.assert_array_equal(res.success.numpy(), np.asarray(jres.success))
    np.testing.assert_array_equal(res.iterations.numpy(), np.asarray(jres.iterations))
    assert res.success.all()
    np.testing.assert_array_equal(T.pack_bits(res.bits[:, : code.k], device="cpu").numpy(), data)


def test_tm8192_int8_serving_pipeline_matches_jax():
    """The quantized-LLR slice: bytes -> encode -> 3 flips -> hard_to_llrs f32
    -> quantize_llrs int8 (scale 16) -> decode_ms (auto: the int8 layered
    decoder on the CPU; the int8 form of the layered CUDA kernel on a card),
    B=16, against the JAX package's same chain."""
    code = T.LDPCCode.TM8192
    data = np.random.default_rng(2).integers(0, 256, (16, code.k // 8), dtype=np.uint8)
    cw = T.encode(code, data, device="cpu")
    cw[:, 0] ^= FLIPS
    llrs = T.quantize_llrs(T.hard_to_llrs(cw, torch.float32, device="cpu"), torch.int8)
    assert T.resolve_impl(code, torch.int8, "auto", "cpu") == "layered"
    res = T.decode_ms(code, llrs, maxiters=12, device="cpu")

    jcw = np.array(J.encode(J.LDPCCode.TM8192, jnp.asarray(data)))
    jcw[:, 0] ^= FLIPS
    jllrs = jquantize_llrs(J.hard_to_llrs(jnp.asarray(jcw), jnp.float32), jnp.int8)
    jres = J.decode_ms(J.LDPCCode.TM8192, jllrs, maxiters=12)

    np.testing.assert_array_equal(llrs.numpy(), np.asarray(jllrs))
    np.testing.assert_array_equal(res.bits.numpy(), np.asarray(jres.bits))
    np.testing.assert_array_equal(res.success.numpy(), np.asarray(jres.success))
    np.testing.assert_array_equal(res.iterations.numpy(), np.asarray(jres.iterations))
    assert res.success.all()
    np.testing.assert_array_equal(T.pack_bits(res.bits[:, : code.k], device="cpu").numpy(), data)


def test_auto_resolves_per_device():
    assert T.resolve_impl("TM8192", torch.float32, "auto", "cpu") == "layered"
    assert T.resolve_impl("TM8192", torch.float32, "cuda_layered", "cpu") == "cuda_layered"
    llrs = torch.ones((2, 128))
    a = T.decode_ms("TC128", llrs, maxiters=3, impl="cuda_layered", device="cpu")
    b = T.decode_ms("TC128", llrs, maxiters=3, impl="layered", device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize(
    "impl,dtype,match",
    [
        ("sp_layered", torch.bfloat16, "float32 only"),
        ("cuda_layered", torch.float64, "float64 goes to impl='layered'"),
        ("layered", torch.int32, "impl='ref'"),
        ("pallas_qc", torch.int8, "cuda_qc"),
        ("pallas_layered", torch.float32, "cuda_layered"),
        ("sp_pallas", torch.float32, "impl='cuda_sp'"),
        ("bogus", torch.float32, "unknown decoder impl"),
    ],
)
def test_registry_rejects_what_this_slice_lacks(impl, dtype, match):
    with pytest.raises(ValueError, match=match):
        T.decode_ms("TC128", torch.zeros((2, 128), dtype=dtype), impl=impl, device="cpu")


ENTRY_POINTS = {
    "encode": lambda: T.encode("TC128", np.zeros((1, 8), np.uint8)),
    "encode_bits": lambda: T.encode_bits("TC128", np.zeros((1, 64), np.uint8)),
    "hard_to_llrs": lambda: T.hard_to_llrs(np.zeros((1, 16), np.uint8)),
    "decode_ms": lambda: T.decode_ms("TC128", np.ones((1, 128), np.float32)),
    "make_ms_decoder_layered": lambda: T.make_ms_decoder_layered("TC128"),
    "make_ms_decoder_cuda_layered": lambda: T.make_ms_decoder_cuda_layered("TC128"),
    "make_ms_decoder": lambda: T.make_ms_decoder("TC128"),
    "make_ms_decoder_qc": lambda: T.make_ms_decoder_qc("TC128"),
    "make_ms_decoder_qc_int": lambda: T.make_ms_decoder_qc_int("TC128"),
    "make_ms_decoder_cuda_qc": lambda: T.make_ms_decoder_cuda_qc("TC128"),
    "make_encoder": lambda: T.make_encoder("TC128"),
    "decode_bf": lambda: T.decode_bf("TC128", np.zeros((1, 128), np.uint8)),
    "decode_erasures_bits": lambda: T.decode_erasures_bits("TM1280", np.zeros((1, 1408), np.uint8)),
    "decode_erasures_mask": lambda: T.decode_erasures_mask(
        "TM1280", np.zeros((1, 1408), np.uint8), np.zeros((1, 1408), bool)),
    "make_bf_decoder": lambda: T.make_bf_decoder("TC128"),
    "make_bf_decoder_qc": lambda: T.make_bf_decoder_qc("TC128"),
    "make_bf_decoder_cuda": lambda: T.make_bf_decoder_cuda("TC128"),
    "make_sp_decoder": lambda: T.make_sp_decoder("TC128"),
    "make_sp_decoder_layered": lambda: T.make_sp_decoder_layered("TC128"),
    "make_sp_decoder_cuda": lambda: T.make_sp_decoder_cuda("TC128"),
    "waterfall": lambda: T.waterfall("TC128", [0.01], decoder="bf", noise_model="bsc"),
    "make_trial_step": lambda: make_trial_step("TC128", 8),
    "make_bf_trial_step": lambda: make_bf_trial_step("TC128", 8),
    "make_ms_hard_trial_step": lambda: make_ms_hard_trial_step("TC128", 8),
}


@pytest.mark.parametrize("entry", list(ENTRY_POINTS))
def test_entry_point_without_device_raises_when_no_gpu(entry):
    """Entry points run on CUDA unless asked for the CPU; with no card they
    raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ENTRY_POINTS[entry]()
