"""The port's erasure decoders against the JAX package, on the CPU.

`decode_erasures_bits` (the punctured tail erased) and `decode_erasures_mask`
(the tail plus random channel erasures) are held to
labrador_ldpc_tpu.ops.bitflip's on numpy-made codewords of
tests/test_torch_bitflip.py. Tolerance: exact (bits and pass counts are
integer state).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from labrador_ldpc_tpu.ops import bitflip as jbf

import labrador_ldpc_tpu_torch as T
from test_torch_bitflip import received
from test_torch_layered import one_torch_thread  # noqa: F401  (autouse fixture)


def _with_tail(name, rx):
    return np.concatenate([rx, np.zeros((rx.shape[0], T.get_code(name).punctured_bits), np.uint8)], 1)


@pytest.mark.parametrize("maxiters", [20, 0])
@pytest.mark.parametrize("name", ["TM1280", "TM5120", "TM8192"])
def test_decode_erasures_bits_matches_jax(name, maxiters):
    bits = _with_tail(name, received(name, 6, seed=13, clean=2))
    port = T.decode_erasures_bits(name, bits, maxiters, device="cpu")
    ref = jbf.decode_erasures_bits(name, jnp.asarray(bits), maxiters)
    for a, b in zip(port, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("name", ["TM1280", "TM2048"])
def test_decode_erasures_mask_matches_jax(name):
    """Punctured tail plus 3 % random channel erasures, 32 voting passes."""
    bits = _with_tail(name, received(name, 6, seed=17, clean=6))
    erased = np.random.default_rng(19).random(bits.shape) < 0.03
    erased[:, T.get_code(name).n :] = True
    port = T.decode_erasures_mask(name, bits, erased, 32, device="cpu")
    ref = jbf.decode_erasures_mask(name, jnp.asarray(bits), jnp.asarray(erased), 32)
    for a, b in zip(port, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert (port[1] > 0).any()  # more than one pass was needed somewhere
