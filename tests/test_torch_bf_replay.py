"""The CUDA bit-flip kernel's packed algorithm replayed in numpy, on the CPU.

`kernel_replay` follows csrc/bitflip.cu step for step over the table the
wrapper passes (packed words, XORs of windows for the parities, carry-save
counts, the bit-sliced maximum, the erasure vote as one inverse window) and
is held to `bitflip_plain` bit for bit; the kernel's erasure-voting addends,
chosen from the addend table, are held to the checks with one erased
neighbour in the JAX package's H. The kernel's launch shape and windows:
tests/test_torch_bf_launch.py. Tolerance: exact (integer state).
"""

import numpy as np
import pytest
import torch

from labrador_ldpc_tpu.codes.expand import parity_edges as jparity_edges

import labrador_ldpc_tpu_torch as T
from labrador_ldpc_tpu_torch.codes.expand import qc_structure
from labrador_ldpc_tpu_torch.ops import cuda_bf
from labrador_ldpc_tpu_torch.ops.bitflip import bitflip_plain
from labrador_ldpc_tpu_torch.ops.cuda_layered import addend_table
from test_torch_bitflip import received
from test_torch_layered import one_torch_thread  # noqa: F401  (autouse fixture)

TM_NAMES = [c.value for c in T.TM_CODES]


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
