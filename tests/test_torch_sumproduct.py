"""The port's sum-product decoders against the JAX package, on the CPU.

labrador_ldpc_tpu_torch.ops.sumproduct.layered_sp_plain is the plain version
of the layered BP CUDA kernel (csrc/sumproduct.cu); the TPU kernel
labrador_ldpc_tpu/ops/pallas_sp.py:48 is pinned bit-exact to the XLA twin
labrador_ldpc_tpu.ops.sumproduct.make_sp_decoder_layered (tests/test_pallas_sp.py).
Here the port's decoders are held to the JAX twins on the same numpy-made
true LLRs 2y/sigma^2.

PyTorch's CPU exp/log are not XLA's, and phi cancels for small x (1 - e^-x),
so one ulp of exp becomes a large relative error of phi near PHI_EPS: the
decoders are held by decode outcomes, not bit for bit. Tolerances, with what
was measured on all nine codes at maxiters 12:
  * frames the JAX twin converges: identical bits and success, iterations
    within 1 (measured: identical iterations);
  * frames the JAX twin fails: at most 1 more or fewer success in the batch
    (measured: the same, with identical bits);
  * maxiters 0 exact; maxiters 1 identical bits on a clean batch;
  * the trial step's LLRs bit for bit (one IEEE float32 multiply each side).
The registry entries, trial step, waterfall and CLI of these decoders:
tests/test_torch_sp_channel.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from labrador_ldpc_tpu.codes.params import ALL_CODES
from labrador_ldpc_tpu.ops import sumproduct as jsp

import labrador_ldpc_tpu_torch as T
from labrador_ldpc_tpu_torch.codes.expand import qc_structure
from labrador_ldpc_tpu_torch.ops import cuda_sp, sumproduct as tsp
from test_torch_layered import (  # noqa: F401  (one_torch_thread: autouse fixture)
    PARTIAL_EBN0,
    assert_same,
    one_torch_thread,
)

NAMES = [c.value for c in ALL_CODES]
MAXITERS = 12
DECODERS = {  # kind -> (JAX twin, port)
    "layered": (jsp.make_sp_decoder_layered, T.make_sp_decoder_layered),
    "flooding": (jsp.make_sp_decoder, T.make_sp_decoder),
}


def _true_llrs(name, batch, seed, ebn0_db):
    """numpy data bits and float32 true LLRs 2y/sigma^2 of BPSK over AWGN at
    Eb/N0 (the port's copy of tests/test_pallas_sp.py:16)."""
    code = T.get_code(name)
    sigma = T.noise_sigma(ebn0_db, code, "ebn0")
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 2, (batch, code.k), dtype=np.uint8)
    cw = T.encode_bits(code, data, device="cpu").numpy()
    tx = 1.0 - 2.0 * cw.astype(np.float64)
    soft = (tx + rng.normal(0.0, sigma, tx.shape)).astype(np.float32)
    return data, soft * np.float32(2.0 / sigma**2)


def mixed_llrs(name, seed):
    """12 rows 1 dB above the code's partial-convergence point (most converge
    within 12 iterations) and 4 rows 1 dB below it (they fail)."""
    _, good = _true_llrs(name, 12, seed, PARTIAL_EBN0[name] + 1.0)
    _, bad = _true_llrs(name, 4, seed + 1, PARTIAL_EBN0[name] - 1.0)
    return np.concatenate([good, bad])


def assert_outcomes_close(port, ref):
    """The decode-outcome tolerance of the module docstring."""
    ok = np.asarray(ref.success)
    np.testing.assert_array_equal(port.success.numpy()[ok], True)
    np.testing.assert_array_equal(port.bits.numpy()[ok], np.asarray(ref.bits)[ok])
    d_iter = np.abs(port.iterations.numpy()[ok] - np.asarray(ref.iterations)[ok])
    assert d_iter.max(initial=0) <= 1, d_iter
    assert abs(int(port.success.numpy()[~ok].sum())) <= 1
    assert port.bits.dtype == torch.uint8 and port.success.dtype == torch.bool
    assert port.iterations.dtype == torch.int32


def test_phi_matches_jax():
    """phi over 0, the clamp's edges, a log sweep, PHI_CLIP and above, and
    random |t|. Below x = 1e-3 the error is absolute: 1 - e^-x cancels, so an
    ulp of exp moves phi by about 6e-8 / x (measured 0.0513 at x = 1.16e-6);
    above it relative (measured 1.03e-5) plus 2.4e-7 absolute where phi
    rounds to 0 or an ulp of its argument (measured 2.4e-7)."""
    rng = np.random.default_rng(0)
    x = np.concatenate([
        [0.0, 1e-7, 5e-7, 9.99e-7, tsp.PHI_EPS, 1.01e-6, 2e-6],
        np.logspace(-6, np.log10(tsp.PHI_CLIP), 4000),
        [tsp.PHI_CLIP, 25.5, 30.0, 1e3],
        np.abs(rng.standard_normal(20000) * 5), rng.uniform(0.0, 30.0, 20000),
    ]).astype(np.float32)
    assert (tsp.PHI_EPS, tsp.PHI_CLIP) == (jsp.PHI_EPS, jsp.PHI_CLIP)
    want = np.asarray(jsp._phi(jnp.asarray(x))).astype(np.float64)
    got = tsp._phi(torch.from_numpy(x)).numpy().astype(np.float64)
    assert got.dtype == np.float64 and np.isfinite(got).all()
    small = x < 1e-3
    assert np.abs(got - want)[small].max() <= 0.06
    np.testing.assert_allclose(got[~small], want[~small], rtol=2e-5, atol=2.5e-7)
    # the clamp: everything at or below PHI_EPS is phi(PHI_EPS), at or above
    # PHI_CLIP phi(PHI_CLIP)
    assert len(set(got[x <= tsp.PHI_EPS])) == 1 and len(set(got[x >= tsp.PHI_CLIP])) == 1


@pytest.mark.parametrize("kind", list(DECODERS))
@pytest.mark.parametrize("name", NAMES)
def test_sp_matches_jax_all_codes(name, kind):
    llrs = mixed_llrs(name, seed=30 + NAMES.index(name))
    jmake, tmake = DECODERS[kind]
    ref = jmake(name, MAXITERS)(jnp.asarray(llrs))
    port = tmake(name, MAXITERS, device="cpu")(torch.from_numpy(llrs))
    assert_outcomes_close(port, ref)
    ok = np.asarray(ref.success)
    assert ok[:12].sum() >= 8 and not ok[12:].any()  # a mixed batch
    if kind == "layered":
        # the CUDA kernel's wrapper runs its plain version on the CPU
        wrapped = T.make_sp_decoder_cuda(name, MAXITERS, device="cpu")(torch.from_numpy(llrs))
        plain = tsp.layered_sp_plain(qc_structure(name), torch.from_numpy(llrs), MAXITERS)
        assert all(torch.equal(a, b) for a, b in zip(wrapped, plain))
        assert all(torch.equal(a, b) for a, b in zip(wrapped, port))
        assert cuda_sp.launches == 0


@pytest.mark.parametrize("kind", list(DECODERS))
@pytest.mark.parametrize("name", ["TM8192", "TC256"])
def test_sp_maxiters_edges(name, kind):
    """maxiters=0 exactly as the twins (layered: zero bits; flooding: the
    LLRs' hard decisions); maxiters=1 on a clean batch: identical bits."""
    jmake, tmake = DECODERS[kind]
    llrs = mixed_llrs(name, seed=7)
    port, ref = tmake(name, 0, device="cpu")(torch.from_numpy(llrs)), jmake(name, 0)(llrs)
    assert_same(port, ref)
    assert not port.success.any() and not port.iterations.any()
    assert bool(port.bits.any()) == (kind == "flooding")
    _, clean = _true_llrs(name, 8, 3, 100.0)
    port, ref = tmake(name, 1, device="cpu")(torch.from_numpy(clean)), jmake(name, 1)(clean)
    assert_same(port, ref)
    assert port.success.all()
