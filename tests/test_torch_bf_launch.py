"""The CUDA bit-flip kernel's launch shape, packed windows and algorithm, on
the CPU.

`csrc/bitflip.cu` keeps each codeword bit-packed in shared memory, 32
variables or checks a word, and decodes it with one lane group of a warp.
A parity word is the XOR of one 32-bit window of a packed block column per
addend of its row, a count word the carry-save sum of one window of a packed
block row per addend of its column, in three bit planes; the maximum count
is taken bit-sliced and every variable at it flips. The kernel runs only on
the card; here:

  * `launch_config` against the state layout and an H100's limits (the
    footprint table below, computed by hand: a codeword's bits Cc*W words,
    W = M/32 or one for M = 16, parities R*W, three count planes 3*Cc*W; the
    table (R+1) + (Cc+1) + 2*sumA*W ints once a CTA; 256 threads; CTAs an SM
    by `card.ctas_per_sm`);
  * every addend's forward and inverse window, for all nine codes, against
    `perm_rows` of the unpacked block (TC128's column twice in a word too);
  * one voting addend for each punctured code;
  * the packing and unpacking of the hard bits (bit 0 of each byte);
  * `kernel_replay` (tests/test_torch_bitflip.py), the kernel in numpy,
    against `bitflip_plain` bit for bit: bits, success and iterations.
Tolerance: exact (integer state).
"""

import numpy as np
import pytest
import torch

import labrador_ldpc_tpu_torch as T
from labrador_ldpc_tpu_torch.codes.expand import qc_structure
from labrador_ldpc_tpu_torch.ops import cuda_bf
from labrador_ldpc_tpu_torch.ops.bitflip import bitflip_plain
from labrador_ldpc_tpu_torch.ops.qc_minsum import perm_rows
from test_torch_bitflip import (kernel_replay, pack_replay, received, unpack_replay,
                                window_replay)
from test_torch_layered import one_torch_thread  # noqa: F401  (autouse fixture)

NAMES = [c.value for c in T.ALL_CODES]

# lanes a codeword, codewords a CTA, shared bytes, CTAs an SM at 64 registers
FOOTPRINT = {
    "TC128": (4, 64, 9_528, 4),
    "TC256": (4, 64, 9_528, 4),
    "TC512": (8, 32, 9_784, 4),
    "TM1280": (16, 16, 13_344, 4),
    "TM1536": (32, 8, 9_456, 4),
    "TM2048": (32, 8, 13_736, 4),
    "TM5120": (32, 8, 29_120, 4),
    "TM6144": (32, 8, 37_680, 4),
    "TM8192": (32, 8, 54_824, 4),
}


def test_launch_config():
    for name in NAMES:
        s = qc_structure(name)
        M, R, Cc = s.m, s.n_block_rows, s.n_block_cols
        W = max(1, M // 32)
        sumA = sum(map(len, s.rows))
        cfg = cuda_bf.launch_config(name)
        threads, lanes, cws = cfg["threads"], cfg["lanes"], cfg["codewords_per_cta"]
        assert (lanes, cws, cfg["smem_bytes"], cfg["ctas_per_sm"]) == FOOTPRINT[name], name
        assert threads % 32 == 0 and threads <= 1024 and cws * lanes == threads
        assert 32 % lanes == 0 and lanes >= min(32, R * W)  # a parity word a lane
        table = (R + 1) + (Cc + 1) + 2 * sumA * W
        assert cfg["smem_bytes"] == 4 * (table + cws * (4 * Cc * W + R * W)) <= 232_448
        assert len(cuda_bf.kernel_table(name)[0]) == table
        # 1,024 threads an SM at the 64 registers of __launch_bounds__(256, 4)
        assert threads * cfg["ctas_per_sm"] == 1024
        few = cuda_bf.launch_config(name, registers=32)["ctas_per_sm"]
        assert few == min(32, 233_472 // (cfg["smem_bytes"] + 1024), 64 // (threads // 32))
    # TM8192 at 32 registers: shared memory holds 4 CTAs, TC128 the 8 of 64 warps
    assert cuda_bf.launch_config("TM8192", registers=32)["ctas_per_sm"] == 4
    assert cuda_bf.launch_config("TC128", registers=32)["ctas_per_sm"] == 8


@pytest.mark.parametrize("name", NAMES)
def test_windows_are_perm_rows(name):
    """Every addend's forward window of the packed bits and
    inverse window of the packed parities, at every word offset, is
    `perm_rows` of the unpacked block, forward and inverse; for TC128 both
    halves of a window word hold the 16 bits."""
    s = qc_structure(name)
    M, R, Cc = s.m, s.n_block_rows, s.n_block_cols
    W = max(1, M // 32)
    rng = np.random.default_rng(M + Cc)
    bits = rng.integers(0, 2, Cc * M, dtype=np.uint8)
    par = rng.integers(0, 2, R * M, dtype=np.uint8)
    bits_w = pack_replay(bits[None], M, Cc * W)
    par_w = pack_replay(par[None], M, R * W)
    fwd, inv, order = cuda_bf.window_table(s)
    adds = [p for row in s.rows for p in row]
    assert sorted(order.tolist()) == list(range(len(adds)))
    assert [adds[e].col for e in order] == sorted(p.col for p in adds)
    for d, p, src, block, inverse in (
        *((fwd[e], adds[e], bits_w, bits[adds[e].col * M :][:M], False) for e in range(len(adds))),
        *((inv[k], adds[e], par_w, par[adds[e].row * M :][:M], True) for k, e in enumerate(order)),
    ):
        w = window_replay(src, d)
        if M == 16:
            np.testing.assert_array_equal(w >> 16, w & 0xFFFF)
        want = perm_rows(torch.from_numpy(block.copy()), p, inverse=inverse).numpy()
        np.testing.assert_array_equal(unpack_replay(w, M, M)[0], want, err_msg=f"{p} {inverse}")
        # both words of a window lie in the addend's block
        words = np.concatenate([(d >> 5) & 0x1FFF, d >> 18])
        first = (p.row if inverse else p.col) * W
        assert ((first <= words) & (words < first + W)).all()


def test_one_voting_addend():
    """Each punctured code has exactly one addend whose checks vote
    on the erased last block column, on that column; the others none."""
    for code in T.ALL_CODES:
        s = qc_structure(code)
        table, vote, vote_row = cuda_bf.kernel_table(code)
        if not code.params.punctured_bits:
            assert vote == vote_row == -1
            continue
        order = cuda_bf.window_table(s)[2]
        adds = [p for row in s.rows for p in row]
        voter = adds[order[vote]]
        assert voter.col == s.n_block_cols - 1 and voter.row == vote_row
        assert sum(p.col == voter.col for p in s.rows[voter.row]) == 1


def test_pack_unpack():
    """Bit 0 of each hard-bit byte, 32 a word in little-endian bit order (the
    kernel's pack4 multiply), and back; TC128's 16 bits twice a word."""
    rng = np.random.default_rng(7)
    hard = rng.integers(0, 2, (16, 1024), dtype=np.uint8)
    words = pack_replay(hard, 64, 32)
    want = np.packbits(hard, axis=1, bitorder="little").view("<u4")
    np.testing.assert_array_equal(words, want)
    np.testing.assert_array_equal(unpack_replay(words, 64, 1024), hard)
    tc = pack_replay(hard[:, :128], 16, 8)
    np.testing.assert_array_equal(tc & 0xFFFF, tc >> 16)
    np.testing.assert_array_equal(unpack_replay(tc, 16, 128), hard[:, :128])
    # a punctured tail of words stays 0
    np.testing.assert_array_equal(pack_replay(hard, 256, 40)[:, 32:], 0)


@pytest.mark.parametrize("name", ["TC128", "TC256", "TM1280", "TM8192"])
def test_packed_replay_matches_plain(name):
    """The kernel's packed algorithm, replayed in numpy, against the plain
    version at maxiters 0, 1 and 20: clean codewords, 1-12 flips and a tenth
    of the bits flipped (which fail)."""
    rx = received(name, 24, seed=41, clean=3, heavy=5, max_flips=12)
    for maxiters in (0, 1, 20):
        bits, ok, iters = kernel_replay(name, rx, maxiters)
        want = bitflip_plain(qc_structure(name), torch.from_numpy(rx), maxiters)
        np.testing.assert_array_equal(bits, want.bits.numpy())
        np.testing.assert_array_equal(ok, want.success.numpy())
        np.testing.assert_array_equal(iters, want.iterations.numpy())
        if maxiters == 20:
            assert ok[:3].all() and not ok[3:8].any() and ok[8:].any()
