"""The port's reference-order decoder in its saturating int8/int16 forms, its
saturating helpers and the LLR quantizer against the JAX package, on the CPU.

labrador_ldpc_tpu_torch.ops.minsum.make_ms_decoder (impl "ref") on the int
batches of tests/test_torch_int.py (quantized noisy rows, clean rows and
uniform rows over the whole range), held to
labrador_ldpc_tpu.ops.minsum.make_ms_decoder; `_sat_add`/`_sat_sub`/
`_sat_abs` at every pair of limit values; `quantize_llrs` to JAX's on ties
and out-of-range values. Tolerance: exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from labrador_ldpc_tpu.channel import awgn as jawgn
from labrador_ldpc_tpu.ops import minsum as jminsum

import labrador_ldpc_tpu_torch as T
from test_torch_layered import one_torch_thread  # noqa: F401  (autouse fixture)
from test_torch_ref import JDTYPES, NAMES, assert_ref_matches_jax


@pytest.mark.parametrize("dtype", [torch.int8, torch.int16], ids=["i8", "i16"])
@pytest.mark.parametrize("name", NAMES)
def test_ref_matches_jax(name, dtype):
    assert_ref_matches_jax(name, dtype)


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
