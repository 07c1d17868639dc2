"""The CUDA encoder kernel's launch shape, packing and packed product, on the
CPU.

`csrc/encoder.cu` packs each codeword's data bits 32 a word (bit b of word w
is data bit 32w + b, bit 0 of its byte) and computes parity bit j as
popc(XOR over w of d_w & g_jw) & 1 against the generator's parity block
packed the same way along k (`cuda_encoder.packed_generator`). A CTA takes
BM codewords and `tiles` tiles of BN parity columns; the CTAs of group 0
also store the systematic head. The kernel runs only on the card; here:

  * `kernel_replay`, the kernel in numpy CTA by CTA (its packing, its
    thread-to-output map and its packed product), against the generator's
    product mod 2 and the plain version, bit for bit, at ragged batches: 1,
    33 and a codeword tile plus one; every output byte is written once;
  * `launch_config` for every code: grid, threads, shared bytes within an
    H100's, and tiles that cover k's words and the n - k columns, the
    padding zero and never stored;
  * a CPU tensor takes the plain version, and the kernel's launch counter
    does not move.
Tolerance: exact (bits).
"""

import numpy as np
import pytest
import torch

import labrador_ldpc_tpu_torch as T
from labrador_ldpc_tpu_torch.codes.expand import generator_parity_matrix
from labrador_ldpc_tpu_torch.ops import cuda_encoder
from labrador_ldpc_tpu_torch.ops.card import CTA_SHARED_MAX, H100_SMS
from labrador_ldpc_tpu_torch.ops.encoder import encode_bits_plain
from test_torch_layered import one_torch_thread  # noqa: F401  (autouse fixture)

NAMES = [c.value for c in T.ALL_CODES]
UNWRITTEN = 0xAA  # a byte no codeword holds


def pack_replay(data: np.ndarray, k_words: int) -> np.ndarray:
    """The kernel's prologue: (B, k) bytes -> (B, k_words) uint32, bit b of
    word w the bit 0 of byte 32w + b, zero past k."""
    B, k = data.shape
    out = np.zeros((B, k_words), dtype=np.uint32)
    bits = (data & 1).astype(np.uint32).reshape(B, k // 32, 32)
    out[:, : k // 32] = (bits << np.arange(32, dtype=np.uint32)).sum(axis=-1, dtype=np.uint32)
    return out


def thread_map(bm: int, bn: int) -> tuple[np.ndarray, np.ndarray]:
    """The tile's (row, column) of each thread's 8 x 8 accumulators, as the
    kernel indexes them: rows ty*4 + {0..3} and BM/2 + ty*4 + {0..3},
    columns tx*4 + {0..3} and BN/2 + tx*4 + {0..3}, ty, tx = tid // (BN/8),
    tid % (BN/8)."""
    tid = np.arange((bm // 8) * (bn // 8))
    tx, ty = tid % (bn // 8), tid // (bn // 8)
    i, j = np.arange(8), np.arange(8)
    rows = np.where(i < 4, ty[:, None] * 4 + i, bm // 2 + ty[:, None] * 4 + i - 4)
    cols = np.where(j < 4, tx[:, None] * 4 + j, bn // 2 + tx[:, None] * 4 + j - 4)
    return (np.broadcast_to(rows[:, :, None], (len(tid), 8, 8)),
            np.broadcast_to(cols[:, None, :], (len(tid), 8, 8)))


def kernel_replay(code, data: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The kernel in numpy, CTA by CTA: the (B, n) codewords and how many
    times each byte was stored."""
    B, k = data.shape
    n, nk = code.n, code.n - code.k
    cfg = cuda_encoder.launch_config(code, B, H100_SMS)
    bm, bn, tiles = cfg["bm"], cfg["bn"], cfg["tiles"]
    gen = cuda_encoder.packed_generator(code)
    out = np.full((B, n), UNWRITTEN, dtype=np.uint8)
    stores = np.zeros((B, n), dtype=np.int64)
    rows_t, cols_t = thread_map(bm, bn)
    for gy in range(cfg["row_tiles"]):
        m0 = gy * bm
        tile_data = np.zeros((bm, k), dtype=np.uint8)
        valid = min(bm, B - m0)
        tile_data[:valid] = data[m0 : m0 + valid]
        words = pack_replay(tile_data, cfg["k_words"])  # sA, by codeword
        for gx in range(cfg["groups"]):
            if gx == 0:  # the systematic head
                out[m0 : m0 + valid, :k] = data[m0 : m0 + valid]
                stores[m0 : m0 + valid, :k] += 1
            for t in range(tiles):
                col0 = (gx * tiles + t) * bn
                # acc ^= d_w & g_w over every word of k (the stages in order)
                acc = np.bitwise_xor.reduce(words[:, :, None] & gen[None, :, col0 : col0 + bn],
                                            axis=1)
                parity = (np.bitwise_count(acc) & 1).astype(np.uint8)
                row, col = m0 + rows_t, col0 + cols_t
                keep = (row < B) & (col < nk)
                out[row[keep], k + col[keep]] = parity[rows_t[keep], cols_t[keep]]
                stores += np.bincount(row[keep] * n + k + col[keep],
                                      minlength=B * n).reshape(B, n)
    return out, stores


def _data(name: str, B: int) -> np.ndarray:
    rng = np.random.default_rng(NAMES.index(name) * 1000 + B)
    return rng.integers(0, 256, (B, T.get_code(name).k), dtype=np.uint8)  # bit 0 is the data bit


@pytest.mark.parametrize("name", NAMES)
def test_kernel_replay(name):
    code = T.get_code(name)
    g = generator_parity_matrix(code).astype(np.float64)  # sums <= 4096: exact
    bm = cuda_encoder.launch_config(code, 1, H100_SMS)["bm"]
    for B in (1, 33, bm + 1):
        data = _data(name, B)
        got, stores = kernel_replay(code, data)
        assert (stores == 1).all(), "every byte of the output is stored exactly once"
        want = np.concatenate([data, ((data & 1) @ g % 2).astype(np.uint8)], 1)
        np.testing.assert_array_equal(got, want)
        plain = encode_bits_plain(code, torch.from_numpy(data)).numpy()
        np.testing.assert_array_equal(got, plain)


@pytest.mark.parametrize("name", NAMES)
def test_launch_config(name):
    code = T.get_code(name)
    k, nk = code.k, code.n - code.k
    gen = cuda_encoder.packed_generator(code)
    for B in (1, 33, 8192, 32768):
        cfg = cuda_encoder.launch_config(code, B, H100_SMS)
        bm, bn = cfg["bm"], cfg["bn"]
        # deep codeword tiles where k is shorter than a square stage (16
        # words), square ones otherwise
        assert (bm, bn, cfg["sw"]) == ((256, 64, 8) if k < 512 else (128, 128, 16))
        assert cfg["threads"] == (bm // 8) * (bn // 8) == 256
        assert cfg["row_tiles"] == -(-B // bm) and cfg["row_tiles"] * bm - B < bm
        # tiles cover k's words, in whole stages that each thread packs one
        # word of, and the n - k columns
        assert cfg["k_words"] % cfg["sw"] == 0 and 0 <= cfg["k_words"] - k // 32 < cfg["sw"]
        assert cfg["threads"] % cfg["k_words"] == 0
        assert cfg["columns"] == cfg["groups"] * cfg["tiles"] * bn
        assert 0 <= cfg["columns"] - nk < bn
        assert gen.shape == (cfg["k_words"], cfg["columns"]) and gen.dtype == np.uint32
        assert not gen[k // 32 :].any() and not gen[:, nk:].any(), "the padding is zero"
        smem = 4 * (cfg["k_words"] * (bm + 4) + 3 * cfg["sw"] * bn)
        assert cfg["smem_bytes"] == smem <= CTA_SHARED_MAX
        assert cfg["ctas_per_sm"] == 2  # the register budget: 128 a thread, 256 threads
        # the fewest groups that give every SM a CTA, or one group a tile
        n_tiles = cfg["groups"] * cfg["tiles"]
        assert cfg["groups"] * cfg["row_tiles"] >= H100_SMS or cfg["tiles"] == 1
        fewer = [g for g in range(1, cfg["groups"]) if n_tiles % g == 0]
        assert all(g * cfg["row_tiles"] < H100_SMS for g in fewer)
    # the packed words hold the generator's bits: bit b of word w is row 32w + b
    g = generator_parity_matrix(code)
    unpacked = (gen[: k // 32, :nk, None] >> np.arange(32, dtype=np.uint32)) & 1
    np.testing.assert_array_equal(unpacked.transpose(0, 2, 1).reshape(k, nk), g)


@pytest.mark.parametrize("name", NAMES)
def test_cpu_takes_plain_path(name, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU tensor reached the CUDA encoder")

    before = cuda_encoder.launches
    monkeypatch.setattr(cuda_encoder, "encode_bits", refuse)
    data = _data(name, 5) & 1
    got = T.encode_bits(name, data, device="cpu")
    assert got.device.type == "cpu" and got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), kernel_replay(T.get_code(name), data)[0])
    assert cuda_encoder.launches == before
    monkeypatch.undo()
    with pytest.raises(ValueError, match="CUDA tensor"):  # the kernel's wrapper has no fallback
        cuda_encoder.encode_bits(name, torch.from_numpy(data))
    assert cuda_encoder.launches == before
