"""The port's bit-flip and erasure decoders against the JAX package, on the CPU.

labrador_ldpc_tpu_torch.ops.bitflip.bitflip_plain is the plain version of the
CUDA kernel csrc/bitflip.cu; both TPU bit-flip kernels (pallas_bf B5 and
pallas_tc B6) are pinned bit-exact to labrador_ldpc_tpu.ops.bitflip's twins.
Here the port's decoders are held to those twins and to the interpreted
kernels on the same numpy-made hard bits, and a numpy replay of the CUDA
kernel's packed algorithm (`kernel_replay`) is held to the plain version.
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


def pack_replay(hard, M, CW):
    """csrc/bitflip.cu's packing in numpy: bit 0 of each byte, 4 bytes a
    multiply, 16 bits a 16-byte load; TC128 (M = 16) keeps a block column's
    16 bits twice in one word. (B, n) uint8 -> (B, CW) uint32 words, the
    punctured tail 0."""
    B, n = hard.shape
    x = np.ascontiguousarray(hard, dtype=np.uint8).view("<u4").astype(np.uint64)
    nib = (((x & 0x01010101) * 0x10204080) & 0xFFFFFFFF) >> 28  # pack4
    nib = nib.reshape(B, -1, 4)
    h = nib[..., 0] | nib[..., 1] << 4 | nib[..., 2] << 8 | nib[..., 3] << 12  # (B, n/16)
    words = np.zeros((B, CW), np.uint64)
    if M == 16:
        words[:, : n // 16] = h | h << 16
    else:
        words[:, : n // 32] = h[:, 0::2] | h[:, 1::2] << 16
    return words.astype(np.uint32)


def unpack_replay(words, M, V):
    """csrc/bitflip.cu's unpacking in numpy: (B, words) -> (B, V) uint8."""
    w = words.astype(np.uint64)
    h = w & 0xFFFF if M == 16 else np.stack([w & 0xFFFF, w >> 16], axis=-1).reshape(len(w), -1)
    nibs = (h[..., None] >> np.arange(0, 16, 4, dtype=np.uint64)) & 15
    spread = ((nibs * 0x00204081) & 0x01010101).astype("<u4")  # unpack4
    return np.ascontiguousarray(spread).view(np.uint8).reshape(len(w), V)


def window_replay(src, ent):
    """csrc/bitflip.cu `window` in numpy: the 32-bit windows of the entries
    `ent` (b | w0 << 5 | w1 << 18) of (B, words) uint32 src -> (B, len(ent))."""
    ent = np.asarray(ent, np.int64)
    lo = src[:, (ent >> 5) & 0x1FFF].astype(np.uint64)
    hi = src[:, ent >> 18].astype(np.uint64)
    return (((hi << 32 | lo) >> (ent & 31).astype(np.uint64)) & 0xFFFFFFFF).astype(np.uint32)


def kernel_replay(name, hard, maxiters):
    """csrc/bitflip.cu step for step in numpy, all codewords at once, over
    the table the wrapper passes (ops/cuda_bf.kernel_table): packed words,
    XORs of windows for the parities, carry-save counts in three planes, the
    bit-sliced maximum from seven ORs and the flip of every variable at it,
    the erasure vote as one inverse window; then unpacked."""
    code = T.get_code(name)
    s = qc_structure(name)
    M, R, Cc = s.m, s.n_block_rows, s.n_block_cols
    W = max(1, M // 32)
    table, vote, vote_row = cuda_bf.kernel_table(code)
    row_off, col_off = table[: R + 1], table[R + 1 : R + Cc + 2]
    sumA = int(row_off[-1])
    fwd, inv = table[R + Cc + 2 :].reshape(2, sumA, W)
    B = len(hard)
    bits = pack_replay(hard, M, Cc * W)
    par = np.zeros((B, R * W), np.uint32)

    def parity(r):
        p = np.zeros((B, W), np.uint32)
        for e in range(row_off[r], row_off[r + 1]):
            p ^= window_replay(bits, fwd[e])
        par[:, r * W : (r + 1) * W] = p

    if maxiters > 0 and vote >= 0:
        parity(vote_row)
        bits[:, (Cc - 1) * W :] = window_replay(par, inv[vote])
    active = np.ones(B, bool)
    converged = np.zeros(B, bool)
    it_done = np.full(B, maxiters, np.int32)
    for it in range(maxiters):
        if not active.any():
            break
        for r in range(R):
            parity(r)
        newly = active & ~(par != 0).any(axis=1)
        converged |= newly
        it_done[newly] = it
        active &= ~newly
        c0, c1, c2 = (np.zeros((B, Cc * W), np.uint32) for _ in range(3))
        for c in range(Cc):
            p0, p1, p2 = (np.zeros((B, W), np.uint32) for _ in range(3))
            for e in range(col_off[c], col_off[c + 1]):
                w = window_replay(par, inv[e])
                k0 = p0 & w
                p0 ^= w
                p2 |= p1 & k0
                p1 ^= k0
            cols = slice(c * W, (c + 1) * W)
            c0[:, cols], c1[:, cols], c2[:, cols] = p0, p1, p2

        def any_(a):
            return (a != 0).any(axis=1)[:, None]

        m2 = any_(c2)
        m1 = np.where(m2, any_(c2 & c1), any_(~c2 & c1))
        m0 = np.where(m2, np.where(m1, any_(c2 & c1 & c0), any_(c2 & ~c1 & c0)),
                      np.where(m1, any_(~c2 & c1 & c0), any_(~c2 & ~c1 & c0)))
        eq = np.where(m2, c2, ~c2) & np.where(m1, c1, ~c1) & np.where(m0, c0, ~c0)
        bits[active] ^= eq[active]
    return unpack_replay(bits, M, Cc * M), converged, it_done


@pytest.mark.parametrize(
    "name,maxiters", [("TM1280", 20), ("TM1280", 0), ("TC256", 20), ("TM6144", 1)]
)
def test_kernel_replay_matches_plain(name, maxiters):
    """The CUDA kernel's packed algorithm (window XORs for the parities,
    carry-save counts, the bit-sliced maximum, the erasure vote as one
    window) gives the plain version's bits, success and iterations."""
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
