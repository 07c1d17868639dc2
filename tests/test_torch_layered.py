"""The port's layered min-sum twin against the JAX twin, on the CPU.

labrador_ldpc_tpu_torch.ops.qc_minsum.make_ms_decoder_layered is the plain
version of the CUDA kernel; both TPU kernels of the main path are pinned
bit-exact to labrador_ldpc_tpu.ops.qc_minsum.make_ms_decoder_layered. Here
the port's twin is held to that JAX twin on the same seeded LLRs.
Tolerance: bit-exact in bits, success and iterations (the arithmetic is the
same IEEE float32 operations in the same order). The nine-code sweep is
in tests/test_torch_layered_codes.py, which shares the helpers below.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from labrador_ldpc_tpu.codes.expand import qc_structure as jqc_structure
from labrador_ldpc_tpu.ops import qc_minsum as jqc

import labrador_ldpc_tpu_torch as T
from labrador_ldpc_tpu_torch.codes.expand import qc_structure as tqc_structure
from labrador_ldpc_tpu_torch.ops import cuda_layered, qc_minsum as tqc

# Eb/N0 (dB) at which a B=64, maxiters=20 batch partly converges, per code
PARTIAL_EBN0 = {
    "TC128": 1.5, "TC256": 2.0, "TC512": 2.0, "TM1280": 3.0, "TM1536": 2.0,
    "TM2048": 1.5, "TM5120": 2.75, "TM6144": 2.0, "TM8192": 1.5,
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run PyTorch's CPU ops on one thread. The suite runs in several worker
    processes beside JAX's own threads; PyTorch's intra-op threads then wait
    on each other at every small op and a decode takes many times longer."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def noisy_llrs(name, batch, ebn0_db, seed):
    """BPSK over AWGN at Eb/N0, unscaled f32 LLRs (min-sum is scale-free)."""
    code = T.get_code(name)
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 2, (batch, code.k), dtype=np.uint8)
    cw = T.encode_bits(code, data, device="cpu").numpy()
    sigma = np.sqrt(1.0 / (2.0 * code.k / code.n * 10.0 ** (ebn0_db / 10.0)))
    noise = sigma * rng.standard_normal(cw.shape)
    return (1.0 - 2.0 * cw + noise).astype(np.float32)


def assert_same(port, ref):
    np.testing.assert_array_equal(port.bits.numpy(), np.asarray(ref.bits))
    np.testing.assert_array_equal(port.success.numpy(), np.asarray(ref.success))
    np.testing.assert_array_equal(port.iterations.numpy(), np.asarray(ref.iterations))
    assert port.bits.dtype == torch.uint8
    assert port.success.dtype == torch.bool
    assert port.iterations.dtype == torch.int32


def run_both(name, llrs, maxiters, alpha=None, self_corrected=True):
    ref = jqc.make_ms_decoder_layered(
        name, jnp.float32, maxiters=maxiters, alpha=alpha, self_corrected=self_corrected
    )(jnp.asarray(llrs))
    port = T.make_ms_decoder_layered(
        name, maxiters, alpha, self_corrected, device="cpu"
    )(torch.from_numpy(llrs))
    return port, ref


def _perm(name, kind):
    for structure in (tqc_structure(name), jqc_structure(name)):
        yield next(p for row in structure.rows for p in row if p.kind == kind)


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("kind", ["rot", "pi"])
def test_perm_rows_matches_jax(kind, inverse):
    tperm, jperm = _perm("TM8192", kind)
    x = np.random.default_rng(5).standard_normal((2048, 3)).astype(np.float32)
    got = tqc.perm_rows(torch.from_numpy(x), tperm, inverse)
    want = jqc.perm_rows(jnp.asarray(x), jperm, inverse)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # and it is the permutation of the code table
    idx = tperm.apply(np.arange(2048), 2048)
    if inverse:
        np.testing.assert_array_equal(got.numpy()[idx], x)
    else:
        np.testing.assert_array_equal(got.numpy(), x[idx])


def test_twin_matches_jax_tm8192_deep():
    """TM8192 at 1.0 dB, B=256, maxiters=50: deep iterations and failures."""
    llrs = noisy_llrs("TM8192", 256, 1.0, seed=3)
    port, ref = run_both("TM8192", llrs, maxiters=50)
    assert_same(port, ref)
    assert 0 < int(port.success.sum()) < 256
    assert int(port.iterations.max()) == 50 and float(port.iterations.float().mean()) > 20


@pytest.mark.parametrize(
    "case,name,kwargs",
    [
        ("alpha", "TM2048", dict(maxiters=20, alpha=0.8)),
        ("alpha", "TC256", dict(maxiters=20, alpha=0.8)),
        ("maxiters1", "TM8192", dict(maxiters=1)),
        ("maxiters1", "TM1536", dict(maxiters=1)),
        ("maxiters0", "TM5120", dict(maxiters=0)),
        ("not_self_corrected", "TM6144", dict(maxiters=20, self_corrected=False)),
    ],
)
def test_twin_matches_jax_variants(case, name, kwargs):
    llrs = noisy_llrs(name, 32, PARTIAL_EBN0[name] + 0.5, seed=17)
    port, ref = run_both(name, llrs, **kwargs)
    assert_same(port, ref)
    if case == "maxiters0":  # no iteration: nothing converged, bits stay 0
        assert not port.success.any() and not port.bits.any()
        assert (port.iterations == 0).all()


def test_twin_clean_and_three_flip_codewords_converge():
    """Clean codewords converge at iteration 0 and keep the sent bits;
    3 flipped bits in byte 0 are corrected, with the punctured tail part of
    `bits` and identical to the JAX twin's."""
    code = T.get_code("TM2048")
    data = np.random.default_rng(9).integers(0, 256, (6, code.k // 8), dtype=np.uint8)
    cw = T.encode(code, data, device="cpu")
    cw[3:, 0] ^= (1 << 7) | (1 << 5) | (1 << 3)
    llrs = T.hard_to_llrs(cw, device="cpu").numpy()
    port, ref = run_both("TM2048", llrs, maxiters=50)
    assert_same(port, ref)
    assert port.success.all()
    assert (port.iterations[:3] == 0).all() and (port.iterations[3:] > 0).all()
    assert port.bits.shape == (6, code.n + code.punctured_bits)
    sent = T.encode(code, data, device="cpu")
    np.testing.assert_array_equal(T.pack_bits(port.bits[:, : code.n], device="cpu"), sent)


def test_cuda_wrapper_on_cpu_tensor_is_the_twin():
    """On a CPU tensor the kernel wrapper runs the plain version and launches
    nothing."""
    llrs = noisy_llrs("TM1280", 32, 3.0, seed=21)
    before = cuda_layered.launches
    got = T.make_ms_decoder_cuda_layered("TM1280", 20, device="cpu")(torch.from_numpy(llrs))
    want = T.make_ms_decoder_layered("TM1280", 20, device="cpu")(torch.from_numpy(llrs))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert cuda_layered.launches == before == 0


def test_layered_rejects_what_this_slice_lacks():
    dec = T.make_ms_decoder_layered("TC128", 5, device="cpu")
    with pytest.raises(ValueError, match="Queue A5"):
        dec(torch.zeros((2, 128), dtype=torch.bfloat16))
    with pytest.raises(ValueError, match=r"\(B, 128\)"):
        dec(torch.zeros((2, 64)))
