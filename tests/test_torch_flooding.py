"""The port's flooding min-sum (float32) against the JAX twin and the
interpreted TPU kernels B3/B4, on the CPU.

labrador_ldpc_tpu_torch.ops.qc_minsum.flooding_minsum_plain is the plain
version of the flooding CUDA kernel (csrc/flooding_minsum.cu); both TPU
flooding kernels are pinned bit-exact to labrador_ldpc_tpu.ops.qc_minsum.
make_ms_decoder_qc. Here the port's decoders are held to that JAX twin on the
same seeded LLRs, and to the TPU kernels run in the Pallas interpreter as
tests/test_pallas.py:24 and tests/test_pallas_tc.py:77 run them.
Tolerance: bit-exact in bits, success and iterations (the same IEEE float32
operations in the same order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from labrador_ldpc_tpu.codes.params import ALL_CODES
from labrador_ldpc_tpu.ops import qc_minsum as jqc
from labrador_ldpc_tpu.ops.pallas_qc import make_ms_decoder_pallas_qc

import labrador_ldpc_tpu_torch as T
from labrador_ldpc_tpu_torch.ops import cuda_qc
from test_torch_layered import (  # noqa: F401  (one_torch_thread: autouse fixture)
    PARTIAL_EBN0,
    assert_same,
    noisy_llrs,
    one_torch_thread,
)

NAMES = [c.value for c in ALL_CODES]


def mixed_llrs(name, seed, n_clean=4, batch=16):
    """A batch of noisy rows near the code's waterfall (some fail within 12
    flooding iterations) and noise-free rows (converge at once, or a few
    iterations later for the punctured codes, whose tail starts at 0)."""
    llrs = noisy_llrs(name, batch, PARTIAL_EBN0[name], seed)
    llrs[:n_clean] = np.sign(noisy_llrs(name, n_clean, 100.0, seed + 1))  # a codeword's +-1
    return llrs


def run_both(name, llrs, maxiters, alpha=None, port=None):
    ref = jqc.make_ms_decoder_qc(name, jnp.float32, maxiters=maxiters, alpha=alpha)(
        jnp.asarray(llrs))
    port = port or T.make_ms_decoder_qc(name, maxiters, alpha, device="cpu")
    return port(torch.from_numpy(llrs)), ref


@pytest.mark.parametrize("name", NAMES)
def test_flooding_matches_jax_all_codes(name):
    """Noisy rows (some converge, some fail at maxiters 12) and clean rows,
    through make_ms_decoder_qc and through the kernel's wrapper on the CPU."""
    llrs = mixed_llrs(name, seed=50 + NAMES.index(name))
    port, ref = run_both(name, llrs, 12)
    assert_same(port, ref)
    assert bool(port.success[:4].all()) and not bool(port.success.all())
    wrapped = T.make_ms_decoder_cuda_qc(name, 12, device="cpu")(torch.from_numpy(llrs))
    assert all(torch.equal(a, b) for a, b in zip(wrapped, port))


@pytest.mark.parametrize(
    "name,kwargs",
    [
        ("TM2048", dict(maxiters=12, alpha=0.8)),
        ("TC256", dict(maxiters=12, alpha=0.8)),
        ("TM8192", dict(maxiters=1)),
        ("TC128", dict(maxiters=1)),
        ("TM5120", dict(maxiters=0)),
    ],
)
def test_flooding_matches_jax_variants(name, kwargs):
    llrs = mixed_llrs(name, seed=70)
    port, ref = run_both(name, llrs, **kwargs)
    assert_same(port, ref)
    if kwargs["maxiters"] == 0:  # no iteration: nothing converged, bits stay 0
        assert not port.success.any() and not port.bits.any()
        assert (port.iterations == 0).all()


@pytest.mark.parametrize("name,batch_tile", [("TM2048", 4), ("TC128", 4)])
def test_flooding_matches_pallas_interpret(name, batch_tile):
    """B3 (TM2048, lane-major) and, through its M <= 256 dispatch, B4
    (TC128, node-major) in the Pallas interpreter, float32."""
    llrs = noisy_llrs(name, 8, PARTIAL_EBN0[name], seed=81)
    ref = make_ms_decoder_pallas_qc(name, jnp.float32, maxiters=12, batch_tile=batch_tile,
                                    interpret=True)(jnp.asarray(llrs))
    port = T.make_ms_decoder_cuda_qc(name, 12, device="cpu")(torch.from_numpy(llrs))
    assert_same(port, ref)


def test_flooding_wrapper_on_cpu_launches_nothing():
    llrs = torch.from_numpy(noisy_llrs("TM1280", 8, 3.0, seed=5))
    before = cuda_qc.launches
    T.make_ms_decoder_cuda_qc("TM1280", 10, device="cpu")(llrs)
    T.decode_ms("TM1280", llrs, maxiters=10, impl="cuda_qc", device="cpu")
    assert cuda_qc.launches == before == 0
    assert set(cuda_qc.form_launches.values()) == {0}


def test_flooding_rejects_what_it_does_not_take():
    with pytest.raises(ValueError, match="make_ms_decoder_qc_int"):
        T.make_ms_decoder_qc("TC128", 5, device="cpu")(torch.zeros((2, 128), dtype=torch.int8))
    with pytest.raises(ValueError, match="float64 LLRs go to impl='layered'"):
        T.make_ms_decoder_cuda_qc("TC128", 5, device="cpu")(
            torch.zeros((2, 128), dtype=torch.float64))
    with pytest.raises(ValueError, match="impl='ref'"):
        T.make_ms_decoder_cuda_qc("TC128", 5, device="cpu")(torch.zeros((2, 128), dtype=torch.int32))
    with pytest.raises(ValueError, match="alpha"):
        T.make_ms_decoder_cuda_qc("TC128", 5, alpha=0.8, device="cpu")(
            torch.zeros((2, 128), dtype=torch.int8))
    with pytest.raises(ValueError, match=r"\(B, 128\)"):
        T.make_ms_decoder_cuda_qc("TC128", 5, device="cpu")(torch.zeros((2, 64)))


def test_kernel_shared_memory_fits_every_code():
    """The kernel keeps a codeword's posteriors, LLRs and each edge's
    variable index in shared memory (the layout of csrc/flooding_minsum.cu,
    `cuda_qc.launch_config`: two planes of Cc*M values of the LLR type and
    sumA*M indices of 2 bytes; the check statistics live in registers): every
    code and dtype fits the 232,448 B a block can address on an H100, with
    room for 1,024 threads an SM (TM8192 float32: 143,360 B)."""
    def smem(code, dtype):
        s = T.qc_structure(code)
        size = torch.empty((), dtype=dtype).element_size()
        return (2 * s.n_block_cols * size + 2 * sum(len(row) for row in s.rows)) * s.m

    dtypes = (torch.float32, torch.int8, torch.int16, torch.bfloat16)
    sizes = {(c.value, dt): smem(c, dt) for c in T.ALL_CODES for dt in dtypes}
    for (name, dt), size in sizes.items():
        cfg = cuda_qc.launch_config(name, dt)
        assert cfg["smem_bytes"] == size and cfg["threads"] * cfg["ctas_per_sm"] == 1024
    assert max(sizes.values()) == sizes[("TM8192", torch.float32)] == 143_360 <= 232_448
    assert (sizes[("TM8192", torch.int8)], sizes[("TM8192", torch.int16)]) == (81_920, 102_400)
