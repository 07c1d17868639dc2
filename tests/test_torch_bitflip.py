"""The port's bit-flip decoders against the JAX package, on the CPU.

labrador_ldpc_tpu_torch.ops.bitflip.bitflip_plain is the plain version of the
CUDA kernel csrc/bitflip.cu; both TPU bit-flip kernels (pallas_bf B5 and
pallas_tc B6) are pinned bit-exact to labrador_ldpc_tpu.ops.bitflip's twins.
Here the port's decoders are held to those twins and to the interpreted
kernels on the same numpy-made hard bits. The erasure decoders:
tests/test_torch_erasure.py; a numpy replay of the CUDA kernel's packed
algorithm (`kernel_replay`) held to the plain version:
tests/test_torch_bf_replay.py. Tolerance: exact (bits, success and
iterations are integer state).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from labrador_ldpc_tpu.ops import bitflip as jbf
from labrador_ldpc_tpu.ops.pallas_bf import make_bf_decoder_pallas
from labrador_ldpc_tpu.ops.pallas_tc import make_bf_decoder_pallas_tc

import labrador_ldpc_tpu_torch as T
from labrador_ldpc_tpu_torch.ops import cuda_bf
from test_torch_layered import one_torch_thread  # noqa: F401  (autouse fixture)

NAMES = [c.value for c in T.ALL_CODES]


def received(name, batch, seed, clean=0, heavy=0, max_flips=6):
    """(B, n) uint8 hard bits of random codewords: the first `clean` as
    sent, the next `heavy` with a tenth of their bits flipped (beyond
    repair), the rest with 1..max_flips flips."""
    code = T.get_code(name)
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 2, (batch, code.k), dtype=np.uint8)
    rx = T.encode_bits(code, data, device="cpu").numpy()
    for i in range(clean, batch):
        nf = code.n // 10 if i < clean + heavy else rng.integers(1, max_flips + 1)
        rx[i, rng.choice(code.n, size=nf, replace=False)] ^= 1
    return rx


def assert_same(port, ref):
    np.testing.assert_array_equal(port.bits.numpy(), np.asarray(ref.bits))
    np.testing.assert_array_equal(port.success.numpy(), np.asarray(ref.success))
    np.testing.assert_array_equal(port.iterations.numpy(), np.asarray(ref.iterations))
    assert port.bits.dtype == torch.uint8
    assert port.success.dtype == torch.bool
    assert port.iterations.dtype == torch.int32


@pytest.mark.parametrize("name", NAMES)
def test_qc_matches_jax(name):
    """Clean, lightly and heavily corrupted codewords in one batch,
    maxiters 20: clean ones converge at iteration 0, heavy ones fail."""
    rx = received(name, 12, seed=3, clean=2, heavy=4)
    port = T.make_bf_decoder_qc(name, 20, device="cpu")(rx)
    ref = jbf.make_bf_decoder_qc(name, 20)(jnp.asarray(rx))
    assert_same(port, ref)
    assert port.success[:2].all() and (port.iterations[:2] == 0).all()
    assert not port.success[2:6].any() and (port.iterations[2:6] == 20).all()
    assert port.success[6:].any()


@pytest.mark.parametrize("name,maxiters", [("TM1280", 0), ("TM1280", 1), ("TC256", 0)])
def test_qc_matches_jax_shallow(name, maxiters):
    rx = received(name, 8, seed=5, clean=2, heavy=2)
    port = T.make_bf_decoder_qc(name, maxiters, device="cpu")(rx)
    assert_same(port, jbf.make_bf_decoder_qc(name, maxiters)(jnp.asarray(rx)))


@pytest.mark.parametrize("name", ["TM1280", "TM2048"])
def test_maxiters0_runs_no_erasure_pass(name):
    """At maxiters=0 the JAX twins run no erasure pass (the punctured tail
    stays 0) while the TPU kernels run theirs regardless; the port follows
    the twins: success False, iterations 0, the sent bits with a zero tail."""
    code = T.get_code(name)
    rx = received(name, 4, seed=7, clean=4)
    port = T.make_bf_decoder_qc(name, 0, device="cpu")(rx)
    assert_same(port, jbf.make_bf_decoder_qc(name, 0)(jnp.asarray(rx)))
    assert not port.success.any() and (port.iterations == 0).all()
    np.testing.assert_array_equal(port.bits[:, : code.n].numpy(), rx)
    assert not port.bits[:, code.n :].any()
    if name == "TM1280":  # the node-major TPU kernel B6 repairs the tail
        kernel = make_bf_decoder_pallas(name, 0, batch_tile=4, interpret=True)(jnp.asarray(rx))
        assert np.asarray(kernel.bits)[:, code.n :].any()


@pytest.mark.parametrize("name", ["TC256", "TM1536", "TM8192"])
def test_gather_matches_jax(name):
    rx = received(name, 8, seed=11, clean=1, heavy=2)
    port = T.make_bf_decoder(name, 20, device="cpu")(rx)
    assert_same(port, jbf.make_bf_decoder(name, 20)(jnp.asarray(rx)))
    assert_same(port, T.make_bf_decoder_qc(name, 20, device="cpu")(rx))


@pytest.mark.parametrize(
    "kernel,name,batch_tile",
    [("B5", "TM2048", 2), ("B6", "TC128", 2), ("B6", "TM1280", 4)],
)
def test_matches_interpreted_tpu_kernel(kernel, name, batch_tile):
    """The interpreted Pallas kernels (as tests/test_pallas_bf.py runs
    them) against the port, a batch with failures, maxiters 8."""
    rx = received(name, 8, seed=23, clean=1, heavy=3)
    make = make_bf_decoder_pallas if kernel == "B5" else make_bf_decoder_pallas_tc
    ref = make(name, 8, batch_tile=batch_tile, interpret=True)(jnp.asarray(rx))
    port = T.make_bf_decoder_qc(name, 8, device="cpu")(rx)
    assert_same(port, ref)
    assert not port.success.all() and port.success.any()


def test_cuda_wrapper_on_cpu_tensor_is_plain():
    """On a CPU tensor the kernel wrapper runs the plain version and
    launches nothing; decode_bf on the CPU gives the JAX decode_bf's result."""
    rx = received("TM1536", 6, seed=31, heavy=1)
    got = T.make_bf_decoder_cuda("TM1536", 20, device="cpu")(rx)
    want = T.make_bf_decoder_qc("TM1536", 20, device="cpu")(rx)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert_same(T.decode_bf("TM1536", rx, 20, device="cpu"), jbf.decode_bf("TM1536", jnp.asarray(rx), 20))
    assert cuda_bf.launches == 0


def test_bitflip_rejects_bad_input():
    dec = T.make_bf_decoder_qc("TC128", 5, device="cpu")
    with pytest.raises(ValueError, match=r"\(B, 128\)"):
        dec(np.zeros((2, 64), np.uint8))
    with pytest.raises(ValueError, match="integer or bool"):
        dec(np.zeros((2, 128), np.float32))
    with pytest.raises(ValueError, match="punctured"):
        T.decode_erasures_bits("TC128", np.zeros((2, 128), np.uint8), device="cpu")
