"""The plain versions of the CUDA kernels' bfloat16 form against the TPU
kernels B1-B4 in the Pallas interpreter (CPU).

The TPU kernels store their state in bfloat16 and compute in float32
(pallas_qc.py:38-41); `layered_minsum_plain` and `flooding_minsum_plain`
follow that storage contract with bfloat16 LLRs (ops/qc_minsum.py
docstring), and the CUDA kernels are held to them on the card
(chip_smoke.py). Here the kernels' wrappers, on CPU tensors, run those plain
versions against the Pallas kernels run as tests/test_pallas.py runs them:
B1 (pallas_qc.make_ms_decoder_pallas_layered, lane-major) on TM2048, B2
(pallas_tc, node-major) on TC128 and TM1536 (quartered pi), B3
(pallas_qc.make_ms_decoder_pallas_qc) on TM2048 and B4 on TC128, and alpha on
B2 and B4, where the kernels keep alpha and alpha * mag in float32.
Tolerance: bit-exact in bits, success and iterations.

Without alpha the same function is the XLA twin's (tests/test_torch_bf16.py);
with alpha the twin rounds alpha and alpha * mag to bfloat16, and the batches
below show that the two contracts then differ.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from labrador_ldpc_tpu.ops.pallas_qc import (
    make_ms_decoder_pallas_layered,
    make_ms_decoder_pallas_qc,
)

import labrador_ldpc_tpu_torch as T
from labrador_ldpc_tpu_torch.ops import cuda_layered, cuda_qc
from test_torch_layered import (  # noqa: F401  (one_torch_thread: autouse fixture)
    PARTIAL_EBN0,
    assert_same,
    noisy_llrs,
    one_torch_thread,
)

# kind -> (TPU kernel, the kernel wrapper of the port, the port's twin)
KERNELS = {
    "layered": (make_ms_decoder_pallas_layered, T.make_ms_decoder_cuda_layered,
                T.make_ms_decoder_layered),
    "flooding": (make_ms_decoder_pallas_qc, T.make_ms_decoder_cuda_qc, T.make_ms_decoder_qc),
}


def mixed(name, seed):
    """8 rows: 6 noisy half a dB above the code's partial-convergence point,
    2 clean ones (+-1)."""
    llrs = noisy_llrs(name, 8, PARTIAL_EBN0[name] + 0.5, seed)
    llrs[:2] = np.sign(noisy_llrs(name, 2, 100.0, seed + 1))
    return llrs


@pytest.mark.parametrize(
    "kernel,kind,name,alpha,batch_tile",
    [
        ("B1", "layered", "TM2048", None, 4),
        ("B2", "layered", "TC128", None, 8),
        ("B2", "layered", "TM1536", None, 8),
        ("B3", "flooding", "TM2048", None, 4),
        ("B4", "flooding", "TC128", None, 8),
        ("B2", "layered", "TC128", 0.8, 8),
        ("B4", "flooding", "TC128", 0.8, 8),
    ],
)
def test_bf16_plain_matches_pallas_interpret(kernel, kind, name, alpha, batch_tile):
    pallas, wrapper, twin = KERNELS[kind]
    llrs = mixed(name, seed=300 + batch_tile)
    ref = pallas(name, jnp.bfloat16, maxiters=10, alpha=alpha, batch_tile=batch_tile,
                 interpret=True)(jnp.asarray(llrs).astype(jnp.bfloat16))
    x = torch.from_numpy(llrs).to(torch.bfloat16)
    port = wrapper(name, 10, alpha, device="cpu")(x)
    assert_same(port, ref)
    assert bool(port.success[:2].all()) and not bool(port.success.all())
    same_as_twin = all(torch.equal(a, b) for a, b in zip(port, twin(name, 10, alpha,
                                                                         device="cpu")(x)))
    assert same_as_twin == (alpha is None)


def test_bf16_wrappers_on_cpu_launch_nothing():
    x = torch.from_numpy(noisy_llrs("TM1280", 8, 3.0, seed=5)).to(torch.bfloat16)
    T.make_ms_decoder_cuda_layered("TM1280", 10, device="cpu")(x)
    T.decode_ms("TM1280", x, maxiters=10, impl="cuda_qc", device="cpu")
    for mod in (cuda_layered, cuda_qc):
        assert mod.launches == 0 and mod.form_launches == dict(f32=0, bf16=0, i8=0, i16=0)

