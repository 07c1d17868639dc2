"""Hand-written CUDA kernel for the Gallager bit-flip decode.

Wraps `csrc/bitflip.cu`, the Hopper port of the two TPU bit-flip kernels
(labrador_ldpc_tpu/ops/pallas_bf.py:53 make_bf_decoder_pallas and
labrador_ldpc_tpu/ops/pallas_tc.py:741 make_bf_decoder_pallas_tc), erasure
pass included, for all nine codes.

On a CPU tensor the wrapper runs the plain version (`bitflip.bitflip_plain`);
on a CUDA tensor it launches the kernel or raises. `launches` counts kernel
launches and nothing else.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from ..codes.expand import qc_structure
from ..codes.params import LDPCCode, get_code
from ..device import resolve_device
from ._nvcc import load_library
from .bitflip import BFResult, _hard_input, bitflip_plain
from .cuda_layered import addend_table, column_order

__all__ = ["make_bf_decoder_cuda", "bitflip", "vote_addends", "SOURCE"]

SOURCE = "bitflip.cu"

# kernel launches since import; read and reset as `cuda_bf.launches`
launches = 0


def vote_addends(table: np.ndarray, n_block_cols: int) -> np.ndarray:
    """Indices of the addends whose checks vote in the erasure pass.

    The erased set is the last block column, so each check of block row r
    has as many erased neighbours as row r has addends on that column; only
    rows with exactly one vote, through that one addend."""
    ecol = n_block_cols - 1
    on_ecol = np.flatnonzero(table[:, 1] == ecol)
    rows, counts = np.unique(table[on_ecol, 0], return_counts=True)
    single = set(rows[counts == 1].tolist())
    return np.asarray([e for e in on_ecol if table[e, 0] in single], dtype=np.int32)


@lru_cache(maxsize=None)
def _device_tables(code: LDPCCode, device: torch.device) -> dict:
    s = qc_structure(code)
    M, Cc = s.m, s.n_block_cols
    # perm_index / perm_inverse reduce mod M and mod M/4 with masks
    if M & (M - 1) or M % 4:
        raise ValueError(f"the CUDA bit-flip kernel needs a power-of-two M, {code} has {M}")
    p = code.params
    if p.punctured_bits and (p.punctured_bits != M or p.n != (Cc - 1) * M):
        raise ValueError(
            f"the CUDA bit-flip kernel's erasure pass needs the punctured bits to be the "
            f"last block column; {code} has {p.punctured_bits} punctured bits, M={M}"
        )
    table, row_off = addend_table(s)
    col_edges, col_off = column_order(table, Cc)
    votes = vote_addends(table, Cc) if p.punctured_bits else np.zeros(0, np.int32)
    as_dev = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=device)  # noqa: E731
    return dict(table=as_dev(table), row_off=as_dev(row_off), col_edges=as_dev(col_edges),
                col_off=as_dev(col_off), vote_edges=as_dev(votes))


@lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    fn = lib.bitflip_u8
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ptr] * 9 + [i32] * 7 + [ptr]
    fn.restype = i32
    return lib


def _launch(code: LDPCCode, hard: torch.Tensor, maxiters: int) -> BFResult:
    global launches
    s = qc_structure(code)
    M, R, Cc = s.m, s.n_block_rows, s.n_block_cols
    B, n = hard.shape
    dev = hard.device
    hard = hard.contiguous()
    bits = torch.empty((B, Cc * M), dtype=torch.uint8, device=dev)
    success = torch.empty((B,), dtype=torch.bool, device=dev)
    iterations = torch.empty((B,), dtype=torch.int32, device=dev)
    if B == 0:
        return BFResult(success, iterations, bits)
    t = _device_tables(code, dev)
    fn = _lib().bitflip_u8
    with torch.cuda.device(dev):
        err = fn(
            hard.data_ptr(), bits.data_ptr(), success.data_ptr(), iterations.data_ptr(),
            t["table"].data_ptr(), t["row_off"].data_ptr(), t["col_edges"].data_ptr(),
            t["col_off"].data_ptr(), t["vote_edges"].data_ptr(), t["vote_edges"].numel(),
            B, n, M, R, Cc, maxiters, torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"bitflip_u8 launch failed with CUDA error {err}")
    launches += 1
    return BFResult(success, iterations, bits)


def bitflip(code: LDPCCode | str, hard_bits: torch.Tensor, maxiters: int) -> BFResult:
    """Decode (B, n) 0/1 hard bits where they lie: the kernel on CUDA, the
    plain version on the CPU."""
    code = get_code(code)
    if not isinstance(hard_bits, torch.Tensor):
        raise TypeError(f"bitflip takes a torch.Tensor, got {type(hard_bits).__name__}")
    hard = _hard_input(hard_bits, code.n, hard_bits.device)
    if hard.device.type == "cuda":
        return _launch(code, hard, maxiters)
    if hard.device.type == "cpu":
        return bitflip_plain(qc_structure(code), hard, maxiters)
    raise ValueError(f"bitflip takes CUDA or CPU tensors, got {hard.device}")


def make_bf_decoder_cuda(code: LDPCCode | str, maxiters: int = 20, device="cuda"):
    """Bit-flip decoder through the CUDA kernel.

    Returns fn(hard_bits: (B, n) 0/1 integers) -> BFResult, run on `device`;
    `device="cpu"` runs the plain version.
    """
    code = get_code(code)
    dev = resolve_device(device)

    def decode(hard_bits) -> BFResult:
        return bitflip(code, torch.as_tensor(hard_bits, device=dev), maxiters)

    return decode
