"""The port's layered twin against the two TPU kernels it stands in for.

The TPU kernels run in the Pallas interpreter on the CPU, the way
tests/test_pallas.py:224 runs them: pallas_qc.make_ms_decoder_pallas_layered
for TM2048 (lane-major, M >= 512) and, through its M <= 256 dispatch,
pallas_tc.make_ms_decoder_pallas_tc_layered for TC128 (node-major).
Tolerance: bit-exact in bits, success and iterations.
"""

import jax.numpy as jnp
import pytest
import torch

from labrador_ldpc_tpu.ops.pallas_qc import make_ms_decoder_pallas_layered

import labrador_ldpc_tpu_torch as T
from test_torch_layered import (  # noqa: F401  (one_torch_thread: autouse fixture)
    assert_same,
    noisy_llrs,
    one_torch_thread,
)


@pytest.mark.parametrize("name,ebn0,batch_tile", [("TM2048", 1.5, 4), ("TC128", 1.5, 8)])
def test_twin_matches_pallas_layered_interpret(name, ebn0, batch_tile):
    llrs = noisy_llrs(name, 8, ebn0, seed=31)
    ref = make_ms_decoder_pallas_layered(
        name, jnp.float32, maxiters=10, batch_tile=batch_tile, interpret=True
    )(jnp.asarray(llrs))
    port = T.make_ms_decoder_cuda_layered(name, 10, device="cpu")(torch.from_numpy(llrs))
    assert_same(port, ref)
