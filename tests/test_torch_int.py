"""The port's saturating int8/int16 flooding min-sum against the JAX twin, on
the CPU.

labrador_ldpc_tpu_torch.ops.qc_minsum.flooding_minsum_plain on int LLRs is
the plain version of the int forms of the flooding CUDA kernel; the TPU
kernels B3/B4 are pinned bit-exact to labrador_ldpc_tpu.ops.qc_minsum.
make_ms_decoder_qc_int, and B1/B2 to make_ms_decoder_layered with an int
dtype (the interpreted kernels themselves: tests/test_torch_int_pallas.py).
Each batch mixes quantized noisy rows (some fail), clean rows and uniform
random LLRs over the whole int range, which hit every saturation point
(tests/test_pallas.py:295). Tolerance: bit-exact in bits, success and
iterations (integer arithmetic).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from labrador_ldpc_tpu.codes.params import ALL_CODES
from labrador_ldpc_tpu.ops import qc_minsum as jqc

import labrador_ldpc_tpu_torch as T
from test_torch_layered import (  # noqa: F401  (one_torch_thread: autouse fixture)
    PARTIAL_EBN0,
    assert_same,
    noisy_llrs,
    one_torch_thread,
)

NAMES = [c.value for c in ALL_CODES]
DTYPES = {"i8": (torch.int8, jnp.int8), "i16": (torch.int16, jnp.int16)}


def int_llrs(name, dtype, seed, batch=16, n_clean=2, n_random=4, ebn0_offset=0.0):
    """(batch, n) numpy LLRs of `dtype`: n_clean quantized clean rows, then
    n_random uniform rows over the dtype's range, then quantized noisy rows."""
    soft = noisy_llrs(name, batch, PARTIAL_EBN0[name] + ebn0_offset, seed)
    soft[:n_clean] = np.sign(noisy_llrs(name, n_clean, 100.0, seed + 1))
    q = T.quantize_llrs(torch.from_numpy(soft), dtype).numpy()
    info = torch.iinfo(dtype)
    rng = np.random.default_rng(seed + 2)
    q[n_clean : n_clean + n_random] = rng.integers(
        info.min, info.max + 1, (n_random, q.shape[1]))
    return q


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("name", NAMES)
def test_int_flooding_matches_jax_all_codes(name, dt):
    tdt, jdt = DTYPES[dt]
    llrs = int_llrs(name, tdt, seed=90 + NAMES.index(name))
    ref = jqc.make_ms_decoder_qc_int(name, jdt, maxiters=12)(jnp.asarray(llrs))
    port = T.make_ms_decoder_qc_int(name, tdt, 12, device="cpu")(torch.from_numpy(llrs))
    assert_same(port, ref)
    assert bool(port.success[:2].all()) and not bool(port.success.all())
    wrapped = T.make_ms_decoder_cuda_qc(name, 12, device="cpu")(torch.from_numpy(llrs))
    assert all(torch.equal(a, b) for a, b in zip(wrapped, port))


@pytest.mark.parametrize(
    "name,dt,maxiters", [("TM8192", "i8", 1), ("TC128", "i16", 1), ("TM1280", "i8", 0)]
)
def test_int_flooding_matches_jax_maxiters(name, dt, maxiters):
    tdt, jdt = DTYPES[dt]
    llrs = int_llrs(name, tdt, seed=7)
    ref = jqc.make_ms_decoder_qc_int(name, jdt, maxiters=maxiters)(jnp.asarray(llrs))
    port = T.make_ms_decoder_qc_i8(name, maxiters, device="cpu") if dt == "i8" else \
        T.make_ms_decoder_qc_int(name, tdt, maxiters, device="cpu")
    port = port(torch.from_numpy(llrs))
    assert_same(port, ref)
    if maxiters == 0:
        assert not port.success.any() and not port.bits.any()


def test_qc_int_refuses_other_dtypes():
    with pytest.raises(ValueError, match="int8/int16"):
        T.make_ms_decoder_qc_int("TC128", torch.int32, device="cpu")
    dec = T.make_ms_decoder_qc_int("TC128", torch.int16, 5, device="cpu")
    with pytest.raises(ValueError, match="built for torch.int16"):
        dec(torch.zeros((2, 128), dtype=torch.int8))
