"""The port's saturating int8/int16 layered min-sum against the JAX twin, on
the CPU, for all nine codes.

labrador_ldpc_tpu_torch.ops.qc_minsum.layered_minsum_plain on int LLRs is
the plain version of the int forms of the layered CUDA kernel; the TPU
kernels B1/B2 are pinned bit-exact to labrador_ldpc_tpu.ops.qc_minsum.
make_ms_decoder_layered with an int dtype: messages saturate, the posterior
stays wide (qc_minsum.py:245-262). Batches as in tests/test_torch_int.py.
Tolerance: bit-exact in bits, success and iterations.
"""

import jax.numpy as jnp
import pytest
import torch

from labrador_ldpc_tpu.codes.params import ALL_CODES
from labrador_ldpc_tpu.ops import qc_minsum as jqc

import labrador_ldpc_tpu_torch as T
from test_torch_int import DTYPES, int_llrs
from test_torch_layered import assert_same, one_torch_thread  # noqa: F401  (autouse fixture)

NAMES = [c.value for c in ALL_CODES]


def run_both(name, dt, llrs, maxiters):
    tdt, jdt = DTYPES[dt]
    ref = jqc.make_ms_decoder_layered(name, jdt, maxiters=maxiters)(jnp.asarray(llrs))
    port = T.make_ms_decoder_layered(name, maxiters, device="cpu")(torch.from_numpy(llrs))
    return port, ref


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("name", NAMES)
def test_int_layered_matches_jax_all_codes(name, dt):
    # the layered schedule converges in about half the flooding's
    # iterations: 0.5 dB lower keeps failures in the batch at maxiters 12
    llrs = int_llrs(name, DTYPES[dt][0], seed=120 + NAMES.index(name), ebn0_offset=-0.5)
    port, ref = run_both(name, dt, llrs, 12)
    assert_same(port, ref)
    assert bool(port.success[:2].all()) and not bool(port.success.all())
    wrapped = T.make_ms_decoder_cuda_layered(name, 12, device="cpu")(torch.from_numpy(llrs))
    assert all(torch.equal(a, b) for a, b in zip(wrapped, port))


@pytest.mark.parametrize(
    "name,dt,maxiters", [("TM8192", "i16", 1), ("TC256", "i8", 1), ("TM6144", "i8", 0)]
)
def test_int_layered_matches_jax_maxiters(name, dt, maxiters):
    llrs = int_llrs(name, DTYPES[dt][0], seed=8)
    port, ref = run_both(name, dt, llrs, maxiters)
    assert_same(port, ref)
    if maxiters == 0:
        assert not port.success.any() and not port.bits.any()


def test_int_layered_refuses_alpha():
    with pytest.raises(ValueError, match="alpha"):
        T.make_ms_decoder_layered("TC128", 5, alpha=0.8, device="cpu")(
            torch.zeros((2, 128), dtype=torch.int8))
