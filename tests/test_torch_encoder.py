"""The port's encoder and converters: golden CCSDS vectors, and equality with
the JAX package on the same seeded data (exact; everything here is integer
or +-1)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden_vectors import GOLDEN_PARITY
from labrador_ldpc_tpu.codes.params import ALL_CODES
from labrador_ldpc_tpu.ops import convert as jconv
from labrador_ldpc_tpu.ops import encoder as jenc

import labrador_ldpc_tpu_torch as T
from test_torch_layered import one_torch_thread  # noqa: F401  (autouse fixture)

NAMES = [c.value for c in ALL_CODES]


@pytest.mark.parametrize("name", NAMES)
def test_golden_encode(name):
    """CCSDS parity for data bytes 0, 1, 2, ... (reference encoder.rs:361-527)."""
    code = T.get_code(name)
    data = np.arange(code.k // 8, dtype=np.uint8)[None]
    cw = T.encode(code, data, device="cpu")
    assert cw.dtype == torch.uint8 and cw.device.type == "cpu"
    assert cw.numpy()[0, : code.k // 8].tobytes() == data.tobytes()
    assert cw.numpy()[0, code.k // 8 :].tobytes() == GOLDEN_PARITY[name]


@pytest.mark.parametrize("name", NAMES)
def test_encode_matches_jax(name):
    code = T.get_code(name)
    rng = np.random.default_rng(100 + NAMES.index(name))
    data = rng.integers(0, 256, (8, code.k // 8), dtype=np.uint8)
    want = np.asarray(jenc.encode(name, jnp.asarray(data)))
    np.testing.assert_array_equal(T.encode(name, data, device="cpu").numpy(), want)
    bits = np.unpackbits(data, axis=1)
    np.testing.assert_array_equal(
        T.encode_bits(name, bits, device="cpu").numpy(),
        np.asarray(jenc.encode_bits(name, jnp.asarray(bits))),
    )
    # encode_onto reads only the data head of a full codeword buffer
    buf = rng.integers(0, 256, (8, code.n // 8), dtype=np.uint8)
    buf[:, : code.k // 8] = data
    np.testing.assert_array_equal(T.encode_onto(name, buf, device="cpu").numpy(), want)


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "bits"])
def test_make_encoder_matches_jax(packed):
    rng = np.random.default_rng(7)
    shape = (5, 4096 // 8) if packed else (5, 4096)
    data = rng.integers(0, 256 if packed else 2, shape, dtype=np.uint8)
    got = T.make_encoder("TM8192", packed, device="cpu")(data)
    want = jenc.make_encoder(jenc.get_code("TM8192"), packed)(jnp.asarray(data))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _data(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


CONVERTERS = {
    "unpack_bits": (
        lambda x: T.unpack_bits(x, device="cpu"),
        lambda x: jconv.unpack_bits(jnp.asarray(x)),
        lambda: _data(1, (3, 7, 16)),
    ),
    "pack_bits": (
        lambda x: T.pack_bits(x, device="cpu"),
        lambda x: jconv.pack_bits(jnp.asarray(x)),
        lambda: np.unpackbits(_data(2, (3, 64)), axis=-1),
    ),
    "hard_to_llrs": (
        lambda x: T.hard_to_llrs(x, torch.float32, device="cpu"),
        lambda x: jconv.hard_to_llrs(jnp.asarray(x), jnp.float32),
        lambda: _data(3, (4, 1024)),
    ),
    "llrs_to_hard": (
        lambda x: T.llrs_to_hard(x, device="cpu"),
        lambda x: jconv.llrs_to_hard(jnp.asarray(x)),
        lambda: np.random.default_rng(4).standard_normal((4, 256)).astype(np.float32),
    ),
}


@pytest.mark.parametrize("conv", list(CONVERTERS))
def test_converter_matches_jax(conv):
    port, ref, make = CONVERTERS[conv]
    x = make()
    got, want = port(x), np.asarray(ref(x))
    assert got.device.type == "cpu"
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    np.testing.assert_array_equal(got.numpy(), want)
