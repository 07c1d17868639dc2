"""The port's layered twin against the JAX twin on all nine codes (CPU).

Noisy seeded LLRs at an Eb/N0 where part of a B=64 batch converges within
maxiters=20, so both converged (frozen) and failed codewords are compared.
Tolerance: bit-exact in bits, success and iterations.
"""

import pytest

from labrador_ldpc_tpu.codes.params import ALL_CODES

from test_torch_layered import (  # noqa: F401  (one_torch_thread: autouse fixture)
    PARTIAL_EBN0,
    assert_same,
    noisy_llrs,
    one_torch_thread,
    run_both,
)


@pytest.mark.parametrize("name", [c.value for c in ALL_CODES])
def test_twin_matches_jax_noisy(name):
    llrs = noisy_llrs(name, 64, PARTIAL_EBN0[name], seed=11)
    port, ref = run_both(name, llrs, maxiters=20)
    assert_same(port, ref)
    n_ok = int(port.success.sum())
    assert 0 < n_ok < 64, f"{name}: {n_ok}/64 converged; pick an Eb/N0 with failures"
