"""bfloat16 LLRs through the port's twins, against the JAX package's XLA twins
on all nine codes (CPU): the layered twin here, the flooding and
reference-order twins and the alpha cases in tests/test_torch_bf16_flooding.py
(the JAX layered twin takes the longest to compile).

The JAX twins compute in bfloat16 (`cdt = dtype`, qc_minsum.py:280, :96):
every op rounds to bfloat16 and alpha is itself a bfloat16; XLA on the CPU
rounds a bfloat16 chain after every op, as PyTorch's bfloat16 ops do. The
port's layered and flooding twins run the plain versions of the CUDA kernels'
bf16 form (bfloat16 storage, float32 arithmetic; ops/qc_minsum.py docstring)
with the twin's bfloat16 alpha: one function serves both contracts, and these
batches show it satisfies the twin's on every frame of all nine codes
(tests/test_torch_bf16_pallas.py holds the same function to the interpreted
TPU kernels). The reference-order decoder computes in bfloat16 as the JAX one
does. Tolerance: bit-exact in bits, success and iterations.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from labrador_ldpc_tpu.codes.params import ALL_CODES
from labrador_ldpc_tpu.ops import minsum as jminsum
from labrador_ldpc_tpu.ops import qc_minsum as jqc

import labrador_ldpc_tpu_torch as T
from test_torch_flooding import mixed_llrs
from test_torch_layered import assert_same, one_torch_thread  # noqa: F401  (autouse fixture)

NAMES = [c.value for c in ALL_CODES]

# kind -> (JAX twin builder, port builder), both (name, maxiters, alpha)
TWINS = {
    "layered": (
        lambda name, mi, alpha: jqc.make_ms_decoder_layered(name, jnp.bfloat16, mi, alpha),
        lambda name, mi, alpha: T.make_ms_decoder_layered(name, mi, alpha, device="cpu"),
    ),
    "qc": (
        lambda name, mi, alpha: jqc.make_ms_decoder_qc(name, jnp.bfloat16, mi, alpha),
        lambda name, mi, alpha: T.make_ms_decoder_qc(name, mi, alpha, device="cpu"),
    ),
    "ref": (
        lambda name, mi, alpha: jminsum.make_ms_decoder(name, jnp.bfloat16, mi, alpha),
        lambda name, mi, alpha: T.make_ms_decoder(name, mi, alpha, device="cpu"),
    ),
}


def run_both(kind, name, llrs, maxiters, alpha=None):
    """The same float32 LLRs, rounded to bfloat16 on each side."""
    jmake, tmake = TWINS[kind]
    ref = jmake(name, maxiters, alpha)(jnp.asarray(llrs).astype(jnp.bfloat16))
    port = tmake(name, maxiters, alpha)(torch.from_numpy(llrs).to(torch.bfloat16))
    return port, ref


def check_twin(kind, name):
    """12 rows: 8 noisy near the code's waterfall (some fail within 12
    iterations) and 4 clean ones (+-1), maxiters 12."""
    llrs = mixed_llrs(name, seed=200 + NAMES.index(name), batch=12)
    port, ref = run_both(kind, name, llrs, 12)
    assert_same(port, ref)
    assert bool(port.success[:4].all()) and not bool(port.success.all())


@pytest.mark.parametrize("name", NAMES)
def test_bf16_layered_twin_matches_jax(name):
    check_twin("layered", name)


def test_bf16_llrs_are_the_rounded_float32_llrs():
    """torch's float32 -> bfloat16 cast rounds to nearest even, as XLA's."""
    x = np.random.default_rng(1).standard_normal(1 << 16).astype(np.float32) * 8
    x[:4] = [1 + 2**-8, 1 + 3 * 2**-8, -(1 + 2**-8), 3.0e38]  # ties and near the max
    got = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    want = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(got, want)
