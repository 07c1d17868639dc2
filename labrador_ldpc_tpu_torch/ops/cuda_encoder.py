"""Hand-written CUDA kernel for the batched systematic GF(2) encoder.

Wraps `csrc/encoder.cu`: (B, k) data bits in, the whole (B, n) uint8
codeword out, in one launch. The JAX package leaves this product to XLA
(labrador_ldpc_tpu/ops/encoder.py), so the kernel replaces no Pallas kernel;
its plain version is `encoder.encode_bits_plain`, a float32 matmul.

The kernel computes the product bit-packed on the CUDA cores: parity bit j
of a codeword is popc(XOR over w of d_w & g_jw) & 1, d_w the codeword's data
bits 32w..32w+31 (bit b of the word is data bit 32w + b) and g_jw the same
bits of column j of `generator_parity_matrix` (`packed_generator`). It is
tiled like a GEMM: a CTA takes BM codewords and a group of tiles of BN
parity columns, `launch_config` (plain Python, no card needed) chooses the
tile shape from k and the groups from B and the card's SMs.

`encode_bits` takes CUDA tensors only and launches the kernel or raises;
`ops/encoder.encode_bits` sends CPU tensors to the plain version.
`launches` counts kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes
from contextlib import nullcontext
from functools import lru_cache

import numpy as np
import torch

from ..codes.expand import generator_parity_matrix
from ..codes.params import LDPCCode, get_code
from ._nvcc import load_library
from .cuda_layered import CTA_SHARED_MAX
from .cuda_sp import ctas_per_sm

__all__ = ["encode_bits", "launch_config", "packed_generator", "SOURCE"]

SOURCE = "encoder.cu"

STAGES = 3  # generator stages in shared memory (csrc/encoder.cu kStages)
TILE_M = TILE_N = 8  # codewords and parity columns a thread
# (codewords, parity columns) a CTA; a generator stage is BN / 8 words of k.
# Deep codeword tiles where k is shorter than a square tile's stage of 16
# words, which would pad k with zero words (TC512's product twice over)
SQUARE, DEEP = (128, 128), (256, 64)
REGISTERS = 128  # __launch_bounds__(threads, 2): at most 128 registers a thread
INPUT_ALIGN = 16  # the kernel loads and stores 16 bytes at a time
MAX_ROW_TILES = 65_535  # gridDim.y

# kernel launches since import; read and reset as `cuda_encoder.launches`
launches = 0


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _check(code: LDPCCode) -> None:
    """Raise a ValueError unless the kernel's packed form fits `code`."""
    k, n = code.k, code.n
    if k % 32:
        raise ValueError(f"the CUDA encoder needs k a multiple of 32: {code} has {k}")
    if n % INPUT_ALIGN or (n - k) % 4:
        raise ValueError(f"the CUDA encoder needs n a multiple of {INPUT_ALIGN} and n - k of 4: "
                         f"{code}")


def _tiles(code: LDPCCode) -> tuple[int, int, int, int, int]:
    """BM, BN, a stage's words of k, k's words padded to whole stages, and
    the BN-column tiles that cover n - k."""
    _check(code)
    bm, bn = DEEP if code.k // 32 < SQUARE[1] // 8 else SQUARE
    sw = bn // 8
    return bm, bn, sw, _round_up(code.k // 32, sw), -(-(code.n - code.k) // bn)


def launch_config(code: LDPCCode | str, B: int, sms: int) -> dict:
    """The kernel's launch shape for `code` and a batch of B on an H100 with
    `sms` SMs.

    Tiles: BM x BN = 256 x 64 (deep codeword tiles) where k is under 512
    bits, 128 x 128 otherwise; a thread computes 8 x 8 of them, so threads =
    BM/8 * BN/8 = 256. The generator is staged sw = BN/8 words of k at a time
    (8 for the deep tiles, 16 for the square ones). k is padded to `k_words`
    (a multiple of sw that divides the threads, which pack one word each)
    and n - k to `columns` (a multiple of BN) with zero generator words; the
    padded columns and the codewords past B are never stored. The BN-column
    tiles are split into `groups` of `tiles` each: the fewest groups (a
    divisor of the tile count) that give each of the `sms` SMs a CTA, since
    every group packs its codewords' data bits again. The grid is (groups,
    row_tiles).

    Shared bytes: the packed data words, k_words x (BM + 4), and three
    generator stages of SW x BN words."""
    code = get_code(code)
    bm, bn, sw, k_words, n_tiles = _tiles(code)
    threads = (bm // TILE_M) * (bn // TILE_N)
    if threads % k_words:
        raise ValueError(f"the CUDA encoder packs a word of k a thread: {code} has {k_words} "
                         f"words, which do not divide {threads} threads")
    smem = 4 * (k_words * (bm + 4) + STAGES * sw * bn)
    if smem > CTA_SHARED_MAX:
        raise ValueError(f"{code} needs {smem} B of shared memory, over {CTA_SHARED_MAX}")
    row_tiles = max(1, -(-B // bm))
    if row_tiles > MAX_ROW_TILES:
        raise ValueError(f"a batch of {B} needs {row_tiles} row tiles, over {MAX_ROW_TILES}")
    groups = next((g for g in range(1, n_tiles + 1)
                   if n_tiles % g == 0 and row_tiles * g >= sms), n_tiles)
    return dict(bm=bm, bn=bn, sw=sw, threads=threads, k_words=k_words, columns=n_tiles * bn,
                groups=groups, tiles=n_tiles // groups, row_tiles=row_tiles, smem_bytes=smem,
                ctas_per_sm=ctas_per_sm(smem, threads, REGISTERS))


_config = lru_cache(maxsize=64)(launch_config)  # the launch's, by (code, B, SMs)


@lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def packed_generator(code: LDPCCode | str) -> np.ndarray:
    """`generator_parity_matrix(code)` packed along k, 32 bits a word: a
    (k_words, columns) uint32 array (`launch_config`'s padding, zero), bit b
    of word [w, j] the generator's entry [32w + b, j]."""
    code = get_code(code)
    _, bn, _, k_words, n_tiles = _tiles(code)
    g = generator_parity_matrix(code)
    k, nk = g.shape
    bits = g.reshape(k // 32, 32, nk).transpose(0, 2, 1)
    words = np.packbits(bits, axis=-1, bitorder="little").view("<u4")[..., 0]
    out = np.zeros((k_words, n_tiles * bn), dtype=np.uint32)
    out[: k // 32, :nk] = words
    return out


@lru_cache(maxsize=None)
def _device_generator(code: LDPCCode, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(packed_generator(code).view(np.int32)).to(device)


@lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.encoder_u8.argtypes = [ptr] * 3 + [i32] * 12 + [ptr]
    lib.encoder_u8.restype = i32
    return lib


def encode_bits(code: LDPCCode | str, bits: torch.Tensor) -> torch.Tensor:
    """(..., k) uint8 data bits on a CUDA card -> (..., n) uint8 codewords,
    by the kernel; bit 0 of each byte is the data bit, and the head is the
    input's bytes, as the plain version's."""
    global launches
    code = get_code(code)
    if not isinstance(bits, torch.Tensor) or bits.device.type != "cuda":
        raise ValueError("the CUDA encoder takes a CUDA tensor")
    if bits.dtype != torch.uint8:
        raise TypeError(f"the CUDA encoder takes uint8 bits, got {bits.dtype}")
    k, n = code.k, code.n
    if bits.shape[-1] != k:
        raise ValueError(f"data bits must be (B, {k}), got {tuple(bits.shape)}")
    lead = bits.shape[:-1]
    data = bits.reshape(-1, k).contiguous()
    if data.data_ptr() % INPUT_ALIGN:
        data = data.clone()  # a fresh allocation is aligned
    B = data.shape[0]
    dev = data.device
    out = torch.empty((B, n), dtype=torch.uint8, device=dev)
    if B == 0:
        return out.reshape(*lead, n)
    index = dev.index
    cfg = _config(code, B, _sms(index))
    gen = _device_generator(code, dev)
    # the raw stream handle, and a device switch only where it is needed: a
    # Stream object and a switch cost more host time than the launch
    with nullcontext() if index == torch.cuda.current_device() else torch.cuda.device(index):
        err = _lib().encoder_u8(
            data.data_ptr(), gen.data_ptr(), out.data_ptr(), B, k, n - k, cfg["k_words"],
            cfg["columns"], cfg["bm"], cfg["bn"], cfg["tiles"], cfg["threads"],
            cfg["smem_bytes"], cfg["groups"], cfg["row_tiles"],
            torch._C._cuda_getCurrentRawStream(index),
        )
    if err != 0:
        raise RuntimeError(f"encoder_u8 launch failed with CUDA error {err}")
    launches += 1
    return out.reshape(*lead, n)
