"""The port's reference-order decoder against the JAX package, on the CPU.

labrador_ldpc_tpu_torch.ops.minsum.make_ms_decoder (impl "ref") is held to
labrador_ldpc_tpu.ops.minsum.make_ms_decoder in float32 and int32, int32
with LLRs near the type's limits so that adds and subs overflow, with alpha,
one iteration and none. Its saturating int8/int16 forms and the LLR
quantizer: tests/test_torch_ref_int.py; the int trial step, the registry and
the CLI: tests/test_torch_registry.py. Tolerance: exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from labrador_ldpc_tpu.codes.params import ALL_CODES
from labrador_ldpc_tpu.ops import minsum as jminsum

import labrador_ldpc_tpu_torch as T
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


def assert_ref_matches_jax(name, dtype):
    """ref_llrs at maxiters 12: the port's decoder gives JAX's bits, success
    and iterations; the two clean rows converge and not every row does."""
    llrs = ref_llrs(name, dtype, seed=200 + NAMES.index(name))
    ref = jminsum.make_ms_decoder(name, JDTYPES[dtype], maxiters=12)(jnp.asarray(llrs))
    port = T.make_ms_decoder(name, 12, device="cpu")(torch.from_numpy(llrs))
    assert_same(port, ref)
    assert bool(port.success[:2].all()) and not bool(port.success.all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32], ids=["f32", "i32"])
@pytest.mark.parametrize("name", NAMES)
def test_ref_matches_jax(name, dtype):
    assert_ref_matches_jax(name, dtype)


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
