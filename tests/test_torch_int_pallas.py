"""The port's saturating int8 min-sum kernels' wrappers against the TPU
kernels B1-B4 in the Pallas interpreter, on the CPU.

On CPU tensors `make_ms_decoder_cuda_qc` and `make_ms_decoder_cuda_layered`
run the plain versions of the CUDA kernels; the TPU kernels run as
tests/test_pallas.py runs them (their f32 formulation with clips), on the
int8 batches of tests/test_torch_int.py: quantized noisy rows, a clean row
and uniform random rows over the whole int8 range. Tolerance: bit-exact in
bits, success and iterations (integer arithmetic).
"""

import jax.numpy as jnp
import pytest
import torch

from labrador_ldpc_tpu.ops.pallas_qc import (
    make_ms_decoder_pallas_layered,
    make_ms_decoder_pallas_qc,
)

import labrador_ldpc_tpu_torch as T
from test_torch_int import int_llrs
from test_torch_layered import (  # noqa: F401  (one_torch_thread: autouse fixture)
    assert_same,
    one_torch_thread,
)


@pytest.mark.parametrize(
    "kernel,name",
    [("B3 flooding", "TM2048"), ("B4 flooding", "TC128"),
     ("B1 layered", "TM2048"), ("B2 layered", "TC128")],
)
def test_int8_matches_pallas_interpret(kernel, name):
    """The TPU kernels in the Pallas interpreter on int8 LLRs (their f32
    formulation with clips), against the port's wrappers on the CPU."""
    llrs = int_llrs(name, torch.int8, seed=11, batch=8, n_clean=1, n_random=2)
    if kernel.endswith("flooding"):
        make, port = make_ms_decoder_pallas_qc, T.make_ms_decoder_cuda_qc
    else:
        make, port = make_ms_decoder_pallas_layered, T.make_ms_decoder_cuda_layered
    ref = make(name, jnp.int8, maxiters=12, batch_tile=4, interpret=True)(jnp.asarray(llrs))
    assert_same(port(name, 12, device="cpu")(torch.from_numpy(llrs)), ref)
