"""The port's bit-flip and erasure decoders against the JAX package, on the CPU.

labrador_ldpc_tpu_torch.ops.bitflip.bitflip_plain is the plain version of the
CUDA kernel csrc/bitflip.cu; both TPU bit-flip kernels (pallas_bf B5 and
pallas_tc B6) are pinned bit-exact to labrador_ldpc_tpu.ops.bitflip's twins.
Here the port's decoders are held to those twins and to the interpreted
kernels on the same numpy-made hard bits, and a numpy replay of the CUDA
kernel's index arithmetic is held to the plain version.
Tolerance: exact (bits, success and iterations are integer state).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from labrador_ldpc_tpu.codes.expand import parity_edges as jparity_edges
from labrador_ldpc_tpu.ops import bitflip as jbf
from labrador_ldpc_tpu.ops.pallas_bf import make_bf_decoder_pallas
from labrador_ldpc_tpu.ops.pallas_tc import make_bf_decoder_pallas_tc

import labrador_ldpc_tpu_torch as T
from labrador_ldpc_tpu_torch.codes.expand import qc_structure
from labrador_ldpc_tpu_torch.ops import cuda_bf
from labrador_ldpc_tpu_torch.ops.bitflip import bitflip_plain
from labrador_ldpc_tpu_torch.ops.cuda_layered import addend_table
from test_torch_layered import one_torch_thread  # noqa: F401  (autouse fixture)

NAMES = [c.value for c in T.ALL_CODES]
TM_NAMES = [c.value for c in T.TM_CODES]


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


def _with_tail(name, rx):
    return np.concatenate([rx, np.zeros((rx.shape[0], T.get_code(name).punctured_bits), np.uint8)], 1)


@pytest.mark.parametrize("maxiters", [20, 0])
@pytest.mark.parametrize("name", ["TM1280", "TM5120", "TM8192"])
def test_decode_erasures_bits_matches_jax(name, maxiters):
    bits = _with_tail(name, received(name, 6, seed=13, clean=2))
    port = T.decode_erasures_bits(name, bits, maxiters, device="cpu")
    ref = jbf.decode_erasures_bits(name, jnp.asarray(bits), maxiters)
    for a, b in zip(port, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("name", ["TM1280", "TM2048"])
def test_decode_erasures_mask_matches_jax(name):
    """Punctured tail plus 3 % random channel erasures, 32 voting passes."""
    bits = _with_tail(name, received(name, 6, seed=17, clean=6))
    erased = np.random.default_rng(19).random(bits.shape) < 0.03
    erased[:, T.get_code(name).n :] = True
    port = T.decode_erasures_mask(name, bits, erased, 32, device="cpu")
    ref = jbf.decode_erasures_mask(name, jnp.asarray(bits), jnp.asarray(erased), 32)
    for a, b in zip(port, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert (port[1] > 0).any()  # more than one pass was needed somewhere


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


@pytest.mark.parametrize("name", TM_NAMES)
def test_kernel_vote_rows_from_addend_table(name):
    """The kernel's erasure-voting addends, chosen from the addend table,
    are exactly the checks with one erased neighbour in H (the JAX
    package's parity_edges), and link each such check to that neighbour."""
    s = qc_structure(name)
    code = T.get_code(name)
    M, Cc = s.m, s.n_block_cols
    table, _ = addend_table(s)
    votes = cuda_bf.vote_addends(table, Cc)
    edges = jparity_edges(name)
    erased_edges = edges[edges[:, 1] >= code.n]
    ecount = np.bincount(erased_edges[:, 0], minlength=code.params.n_checks)
    vote_rows = {int(table[e, 0]) for e in votes}
    assert len(vote_rows) == len(votes) >= 1
    for r in range(s.n_block_rows):
        per_check = ecount[r * M : (r + 1) * M]
        if r in vote_rows:
            assert (per_check == 1).all()
        else:
            assert not (per_check == 1).any()
    i = np.arange(M)
    for e in votes:
        row, col = int(table[e, 0]), int(table[e, 1])
        assert col == Cc - 1
        perm = next(p for p in s.rows[row] if p.col == col)
        want = {(row * M + a, col * M + b) for a, b in zip(i, perm.apply(i, M))}
        got = {(int(c), int(v)) for c, v in erased_edges if row * M <= c < (row + 1) * M}
        assert got == want


def _perm_index(a, i, M):
    """csrc/qc_addend.cuh perm_index over a numpy index vector."""
    if a[2] == 0:
        return (i + a[3]) & (M - 1)
    q = M >> 2
    j = i // q
    return ((a[4] + j) & 3) * q + ((np.asarray(a[5:9])[j] + i) & (q - 1))


def _perm_inverse(a, v, M):
    """csrc/qc_addend.cuh perm_inverse over a numpy index vector."""
    if a[2] == 0:
        return (v - a[3]) & (M - 1)
    q = M >> 2
    j = ((v // q) - a[4]) & 3
    return j * q + ((v - np.asarray(a[5:9])[j]) & (q - 1))


def kernel_replay(name, hard, maxiters):
    """csrc/bitflip.cu step for step in numpy, one codeword at a time, over
    the tables the wrapper passes (ops/cuda_bf._device_tables)."""
    code = T.get_code(name)
    s = qc_structure(name)
    M, R, Cc = s.m, s.n_block_rows, s.n_block_cols
    V, n = Cc * M, code.n
    t = {k: v.numpy() for k, v in cuda_bf._device_tables(code, torch.device("cpu")).items()}
    table = t["table"]
    i = np.arange(M)
    out_bits, out_ok, out_it = [], [], []
    for h in hard:
        bits = np.zeros(V, np.int64)
        bits[:n] = h

        def parity():
            par = np.zeros(R * M, np.int64)
            for r in range(R):
                for e in range(t["row_off"][r], t["row_off"][r + 1]):
                    a = table[e]
                    par[r * M + i] ^= bits[a[1] * M + _perm_index(a, i, M)]
            return par

        if maxiters > 0 and len(t["vote_edges"]):
            par = parity()
            vote = np.zeros(M, np.int64)
            for e in t["vote_edges"]:
                a = table[e]
                vote += np.where(par[a[0] * M + _perm_inverse(a, i, M)] == 1, 1, -1)
            bits[(Cc - 1) * M + i[vote > 0]] = 1
        converged, it_done = 0, maxiters
        for it in range(maxiters):
            par = parity()
            viol = np.zeros(V, np.int64)
            for c in range(Cc):
                for k in range(t["col_off"][c], t["col_off"][c + 1]):
                    a = table[t["col_edges"][k]]
                    viol[c * M + i] += par[a[0] * M + _perm_inverse(a, i, M)]
            m = viol.max()
            if m == 0:
                converged, it_done = 1, it
                break
            bits[viol == m] ^= 1
        out_bits.append(bits)
        out_ok.append(converged)
        out_it.append(it_done)
    return np.asarray(out_bits, np.uint8), np.asarray(out_ok, bool), np.asarray(out_it, np.int32)


@pytest.mark.parametrize(
    "name,maxiters", [("TM1280", 20), ("TM1280", 0), ("TC256", 20), ("TM6144", 1)]
)
def test_kernel_replay_matches_plain(name, maxiters):
    """The CUDA kernel's algorithm (parity by perm_index per row, counts by
    perm_inverse per column, erasure votes through vote_edges) gives the
    plain version's bits, success and iterations."""
    rx = received(name, 6, seed=29, clean=1, heavy=2)
    bits, ok, iters = kernel_replay(name, rx, maxiters)
    want = bitflip_plain(qc_structure(name), torch.from_numpy(rx), maxiters)
    np.testing.assert_array_equal(bits, want.bits.numpy())
    np.testing.assert_array_equal(ok, want.success.numpy())
    np.testing.assert_array_equal(iters, want.iterations.numpy())


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
