"""bfloat16 LLRs through the port's flooding and reference-order twins on all
nine codes, and alpha through all three twins, against the JAX package's XLA
twins (CPU). The contract and the helpers are those of tests/test_torch_bf16.py.
Tolerance: bit-exact in bits, success and iterations.
"""

import pytest

from test_torch_bf16 import NAMES, TWINS, check_twin, run_both
from test_torch_flooding import mixed_llrs
from test_torch_layered import assert_same, one_torch_thread  # noqa: F401  (autouse fixture)


@pytest.mark.parametrize("kind", ["qc", "ref"])
@pytest.mark.parametrize("name", NAMES)
def test_bf16_twin_matches_jax(name, kind):
    check_twin(kind, name)


@pytest.mark.parametrize("kind", list(TWINS))
def test_bf16_twin_matches_jax_alpha(kind):
    """alpha=0.8 is 0.80078125 in bfloat16, and every alpha * mag rounds;
    on TM2048 and TC256."""
    for name in ("TM2048", "TC256"):
        llrs = mixed_llrs(name, seed=230, batch=12)
        port, ref = run_both(kind, name, llrs, 12, alpha=0.8)
        assert_same(port, ref)
        assert bool(port.success[:4].all())
