"""Hand-written CUDA kernel for the Gallager bit-flip decode.

Wraps `csrc/bitflip.cu`, the Hopper port of the two TPU bit-flip kernels
(labrador_ldpc_tpu/ops/pallas_bf.py:53 make_bf_decoder_pallas and
labrador_ldpc_tpu/ops/pallas_tc.py:741 make_bf_decoder_pallas_tc), erasure
pass included, for all nine codes.

On a CPU tensor the wrapper runs the plain version (`bitflip.bitflip_plain`);
on a CUDA tensor it launches the kernel or raises. `launches` counts kernel
launches and nothing else.

The kernel keeps each codeword bit-packed in shared memory (32 variables or
checks a word) and reads each addend as a 32-bit window of a packed block
column or block row (`window_table`). Its launch shape comes from
`launch_config` (plain Python, no card needed); its CTAs stay resident and
take the batch's codewords from a counter, one int32 that the wrapper
allocates with the outputs.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from ..codes.expand import BlockPerm, QCStructure, qc_structure
from ..codes.params import LDPCCode, get_code
from ..device import resolve_device
from ._nvcc import load_library
from .bitflip import BFResult, _hard_input, bitflip_plain
from .cuda_layered import CTA_SHARED_MAX, addend_table
from .cuda_sp import REGISTERS_PER_THREAD, ctas_per_sm
from .routing import route_for

__all__ = ["make_bf_decoder_cuda", "bitflip", "vote_addends", "window_table", "kernel_table",
           "launch_config", "card_ctas_per_sm", "SOURCE"]

SOURCE = "bitflip.cu"

THREADS = 256  # the kernel's CTA, __launch_bounds__(256, 4): at most 64 registers a thread
MAX_COLUMN_DEGREE = 7  # a count fits in three bit planes
INPUT_ALIGN = 16  # the kernel loads the hard bits 16 bytes at a time

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


def _words(m: int) -> int:
    """Words of a packed block column or row: M/32, and one for M = 16
    (TC128), which holds the column's 16 bits twice over."""
    return max(1, m // 32)


def _entry(start: int, word0: int, seg_bits: int) -> int:
    """The window entry (csrc/bitflip.cu `window`) of the 32 bits from bit
    `start` of a block whose packed words begin at word0, in the segment of
    seg_bits bits that holds `start` and that the window wraps in: b | w0 <<
    5 | w1 << 18, with w0 the word of `start`, b its bit and w1 the
    segment's next word."""
    wz = max(1, seg_bits // 32)
    seg0 = word0 + (start // seg_bits) * wz
    rel = start % seg_bits
    return rel % 32 | (seg0 + rel // 32) << 5 | (seg0 + (rel // 32 + 1) % wz) << 18


def window_table(s: QCStructure) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The kernel's view of `qc_structure`: one window entry per addend and
    word, (sumA, W) int32 forward entries in row order and (sumA, W) inverse
    ones in column order, and the (sumA,) row-order index of each inverse one.

    Checks i..i+31 of an addend's block row (i a multiple of 32) read
    variables perm(i) onward of its block column, consecutive and wrapping
    in the addend's segment (the whole block for a rotation, a quarter for a
    pi permutation): forward word i/32 is the window at perm(i) of the packed
    column, and the parity word is the XOR of its row's. Variables o..o+31
    are reached from checks perm^-1(o) onward: inverse word o/32 is the
    window at perm^-1(o) of the packed row of parities, and the count word
    adds its column's. For M = 16 the one word holds the block twice, so
    the window is a rotation of it."""
    m = s.m
    W = _words(m)
    x = np.arange(0, W * 32, 32) % m
    adds = [p for row in s.rows for p in row]
    order = np.argsort([p.col for p in adds], kind="stable").astype(np.int32)

    def entries(p: BlockPerm, forward: bool) -> list[int]:
        perm = p.apply(np.arange(m), m)
        if not forward:
            perm = np.argsort(perm)  # perm^-1
        seg_bits = m if p.kind == "rot" else m // 4
        word0 = (p.col if forward else p.row) * W
        return [_entry(int(perm[i]), word0, seg_bits) for i in x]

    fwd = [entries(p, True) for p in adds]
    inv = [entries(adds[e], False) for e in order]
    return np.asarray(fwd, np.int32), np.asarray(inv, np.int32), order


def _check(code: LDPCCode) -> None:
    """Raise a ValueError unless the kernel's packed form is exact for code."""
    s = qc_structure(code)
    M, Cc = s.m, s.n_block_cols
    if M & (M - 1) or M < 16:
        raise ValueError(f"the CUDA bit-flip kernel needs a power-of-two M >= 16, {code} has {M}")
    if any(p.kind == "pi" for row in s.rows for p in row) and M < 128:
        raise ValueError(f"the CUDA bit-flip kernel needs M/4 >= 32 for a pi permutation: {code}")
    degree = np.bincount([p.col for row in s.rows for p in row]).max()
    if degree > MAX_COLUMN_DEGREE:
        raise ValueError(f"{code} has a column of {degree} addends: the kernel's counts hold "
                         f"{MAX_COLUMN_DEGREE}")
    p = code.params
    if p.n % INPUT_ALIGN:
        raise ValueError(f"the CUDA bit-flip kernel needs n a multiple of {INPUT_ALIGN}: {code}")
    if p.punctured_bits and (p.punctured_bits != M or p.n != (Cc - 1) * M):
        raise ValueError(
            f"the CUDA bit-flip kernel's erasure pass needs the punctured bits to be the "
            f"last block column; {code} has {p.punctured_bits} punctured bits, M={M}"
        )


def kernel_table(code: LDPCCode | str) -> tuple[np.ndarray, int, int]:
    """The kernel's int32 table, row_off (R+1), col_off (Cc+1), then the
    forward and inverse entries of `window_table`; the index among the
    inverse entries' addends of the erasure vote's addend, and its block row
    (-1 and -1 for a code without punctured bits)."""
    code = get_code(code)
    _check(code)
    s = qc_structure(code)
    table, row_off = addend_table(s)
    col_off = np.concatenate([[0], np.cumsum(np.bincount(table[:, 1], minlength=s.n_block_cols))])
    fwd, inv, order = window_table(s)
    vote = vote_row = -1
    if code.params.punctured_bits:
        votes = vote_addends(table, s.n_block_cols)
        if len(votes) != 1:
            raise ValueError(f"the CUDA bit-flip kernel takes one voting addend, {code} has "
                             f"{len(votes)}")
        vote, vote_row = int(np.flatnonzero(order == votes[0])[0]), int(table[votes[0], 0])
    flat = np.concatenate([row_off, col_off, fwd.ravel(), inv.ravel()]).astype(np.int32)
    return flat, vote, vote_row


def launch_config(code: LDPCCode | str, registers: int = REGISTERS_PER_THREAD) -> dict:
    """The kernel's launch shape for `code` on an H100: threads a CTA, the
    lanes of a codeword (the fewest powers of two, 4 to 32, that give each
    parity word of a codeword its own lane) and the codewords a CTA, its
    dynamic shared bytes, and the CTAs that fit on one SM when a thread takes
    `registers` registers (the kernel's budget by default; ptxas's count
    gives the card's), by `cuda_sp.ctas_per_sm`.

    Shared bytes: the table (`kernel_table`: R+1 + Cc+1 + 2*sumA*W ints)
    once a CTA, and a codeword's packed bits (Cc*W words, W = M/32, one for
    M = 16), parities (R*W) and three count planes (3*Cc*W)."""
    code = get_code(code)
    _check(code)
    s = qc_structure(code)
    W = _words(s.m)
    RW, CW = s.n_block_rows * W, s.n_block_cols * W
    lanes = min(32, max(4, 1 << (RW - 1).bit_length()))
    codewords = THREADS // lanes
    table_len = s.n_block_rows + s.n_block_cols + 2 + 2 * W * sum(map(len, s.rows))
    smem = 4 * (table_len + codewords * (4 * CW + RW))
    if smem > CTA_SHARED_MAX:
        raise ValueError(f"{code} needs {smem} B of shared memory, over {CTA_SHARED_MAX}")
    return dict(threads=THREADS, lanes=lanes, codewords_per_cta=codewords, smem_bytes=smem,
                ctas_per_sm=ctas_per_sm(smem, THREADS, registers))


@lru_cache(maxsize=None)
def _device_table(code: LDPCCode, device: torch.device) -> tuple[torch.Tensor, int, int, int]:
    """The table on the device, the vote's addend and row, and the CTAs
    resident on the whole card (its SMs times its CTAs per SM)."""
    table, vote, vote_row = kernel_table(code)
    with torch.cuda.device(device):
        resident = card_ctas_per_sm(code) * torch.cuda.get_device_properties(
            device).multi_processor_count
    return torch.as_tensor(table, device=device), vote, vote_row, resident


@lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.bitflip_u8.argtypes = [ptr] * 6 + [i32] * 13 + [ptr]
    lib.bitflip_u8.restype = i32
    lib.bitflip_u8_ctas_per_sm.argtypes = [i32, i32, ctypes.POINTER(i32)]
    lib.bitflip_u8_ctas_per_sm.restype = i32
    return lib


def card_ctas_per_sm(code: LDPCCode | str) -> int:
    """The CTAs of `launch_config(code)` that fit on one SM of the current
    card, as the CUDA runtime's occupancy calculator reports them."""
    cfg = launch_config(code)
    out = ctypes.c_int()
    err = _lib().bitflip_u8_ctas_per_sm(cfg["threads"], cfg["smem_bytes"], ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"bitflip_u8_ctas_per_sm failed with CUDA error {err}")
    return out.value


def _launch(code: LDPCCode, hard: torch.Tensor, maxiters: int) -> BFResult:
    global launches
    s = qc_structure(code)
    M, R, Cc = s.m, s.n_block_rows, s.n_block_cols
    B, n = hard.shape
    dev = hard.device
    hard = hard.contiguous()
    if hard.data_ptr() % INPUT_ALIGN:
        hard = hard.clone()  # a fresh allocation is aligned
    bits = torch.empty((B, Cc * M), dtype=torch.uint8, device=dev)
    success = torch.empty((B,), dtype=torch.bool, device=dev)
    iterations = torch.empty((B,), dtype=torch.int32, device=dev)
    if B == 0:
        return BFResult(success, iterations, bits)
    counter = torch.empty((1,), dtype=torch.int32, device=dev)
    table, vote, vote_row, resident = _device_table(code, dev)
    cfg = launch_config(code)
    grid = min(resident, -(-B // cfg["codewords_per_cta"]))
    with torch.cuda.device(dev):
        err = _lib().bitflip_u8(
            hard.data_ptr(), bits.data_ptr(), success.data_ptr(), iterations.data_ptr(),
            table.data_ptr(), counter.data_ptr(), table.numel(), vote, vote_row, B, n, M, R,
            Cc, maxiters, cfg["threads"], cfg["lanes"], cfg["smem_bytes"], grid,
            torch.cuda.current_stream(dev).cuda_stream,
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
    route_for(code)  # an unrouted code fails here, before any launch
    dev = resolve_device(device)

    def decode(hard_bits) -> BFResult:
        return bitflip(code, torch.as_tensor(hard_bits, device=dev), maxiters)

    return decode
