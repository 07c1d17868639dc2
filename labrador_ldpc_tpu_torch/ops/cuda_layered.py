"""Hand-written CUDA kernel for the row-layered self-corrected min-sum decode.

Wraps `csrc/layered_minsum.cu`, the Hopper port of the two TPU kernels of
the main path (labrador_ldpc_tpu/ops/pallas_qc.py:728
make_ms_decoder_pallas_layered and labrador_ldpc_tpu/ops/pallas_tc.py:268
make_ms_decoder_pallas_tc_layered), for all nine codes, in float32, in the
TPU kernels' bfloat16 form (bfloat16 storage, float32 arithmetic) and in the
saturating int8/int16 forms (one C entry point per dtype).

On a CPU tensor the wrapper runs the plain version
(`qc_minsum.layered_minsum_plain`); on a CUDA tensor it launches the kernel
or raises. `launches` counts kernel launches and nothing else;
`form_launches` splits the same count by dtype form ("f32", "bf16", "i8",
"i16"). float64 LLRs raise a ValueError, as the TPU kernels refuse them.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from ..codes.expand import QCStructure, qc_structure
from ..codes.params import LDPCCode, get_code
from ..device import resolve_device
from ._nvcc import load_library
from .minsum import MSResult
from .qc_minsum import KERNEL_DTYPES, check_llrs, layered_minsum_plain

__all__ = ["make_ms_decoder_cuda_layered", "layered_minsum", "addend_table", "column_order",
           "FORMS", "SOURCE"]

SOURCE = "layered_minsum.cu"

# the kernels' dtype forms: the suffix of each C entry point
FORMS = {torch.float32: "f32", torch.bfloat16: "bf16", torch.int8: "i8", torch.int16: "i16"}

# kernel launches since import; read and reset as `cuda_layered.launches`
launches = 0
# the same launches by dtype form; reset with `launches`
form_launches = dict.fromkeys(FORMS.values(), 0)


def addend_table(s: QCStructure) -> tuple[np.ndarray, np.ndarray]:
    """The kernel's view of `qc_structure`: (sumA, 9) int32 rows of
    (row, col, kind 0=rot/1=pi, shift, theta, phi0..phi3), and the (R+1,)
    int32 offsets of each layer's first addend."""
    rows, off = [], [0]
    for row in s.rows:
        for p in row:
            phis = tuple(p.phis) if p.kind == "pi" else (0, 0, 0, 0)
            rows.append((p.row, p.col, 0 if p.kind == "rot" else 1, p.shift, p.theta, *phis))
        off.append(off[-1] + len(row))
    return np.asarray(rows, dtype=np.int32), np.asarray(off, dtype=np.int32)


def column_order(table: np.ndarray, n_block_cols: int) -> tuple[np.ndarray, np.ndarray]:
    """The addends grouped by block column, in addend order within a column
    ((sumA,) int32), and the (Cc+1,) int32 offsets of each column's first."""
    col_edges = np.argsort(table[:, 1], kind="stable").astype(np.int32)
    col_off = np.concatenate([[0], np.cumsum(np.bincount(table[:, 1], minlength=n_block_cols))])
    return col_edges, col_off.astype(np.int32)


@lru_cache(maxsize=None)
def _device_tables(code: LDPCCode, device: torch.device):
    s = qc_structure(code)
    # the kernel's perm_index reduces mod M and mod M/4 with masks
    if s.m & (s.m - 1) or s.m % 4:
        raise ValueError(f"the CUDA layered kernel needs a power-of-two M, {code} has {s.m}")
    table, off = addend_table(s)
    return torch.as_tensor(table, device=device), torch.as_tensor(off, device=device)


@lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for form in FORMS.values():
        fn = getattr(lib, f"layered_minsum_{form}")
        fn.argtypes = [ptr] * 8 + [i32] * 8 + [ctypes.c_float, ptr]
        fn.restype = i32
    return lib


def _launch(code: LDPCCode, llrs: torch.Tensor, maxiters: int, alpha: float | None) -> MSResult:
    global launches
    s = qc_structure(code)
    M, R, Cc = s.m, s.n_block_rows, s.n_block_cols
    V = Cc * M
    B, n = llrs.shape
    dev = llrs.device
    llrs = llrs.contiguous()
    bits = torch.empty((B, V), dtype=torch.uint8, device=dev)
    success = torch.empty((B,), dtype=torch.bool, device=dev)
    iterations = torch.empty((B,), dtype=torch.int32, device=dev)
    if B == 0:
        return MSResult(success, iterations, bits)
    table, off = _device_tables(code, dev)
    sumA = table.shape[0]
    # per-edge state lives in device memory, in the LLRs' dtype (bfloat16 for
    # the bf16 form; module docstring of the source); iteration 0 is peeled
    # inside the kernel, so no zeroing
    u = torch.empty((B, sumA, M), dtype=llrs.dtype, device=dev)
    tp = torch.empty((B, sumA, M), dtype=llrs.dtype, device=dev)
    form = FORMS[llrs.dtype]
    fn = getattr(_lib(), f"layered_minsum_{form}")
    with torch.cuda.device(dev):
        err = fn(
            llrs.data_ptr(), bits.data_ptr(), success.data_ptr(), iterations.data_ptr(),
            u.data_ptr(), tp.data_ptr(), table.data_ptr(), off.data_ptr(),
            B, n, M, R, Cc, sumA, maxiters, 0 if alpha is None else 1,
            0.0 if alpha is None else float(alpha),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"layered_minsum_{form} launch failed with CUDA error {err}")
    launches += 1
    form_launches[form] += 1
    return MSResult(success, iterations, bits)


def layered_minsum(code: LDPCCode | str, llrs: torch.Tensor, maxiters: int,
                   alpha: float | None = None) -> MSResult:
    """Decode (B, n) float32, bfloat16, int8 or int16 LLRs where they lie: the
    kernel on CUDA, the plain version on the CPU."""
    code = get_code(code)
    check_llrs(llrs, code.n, alpha, KERNEL_DTYPES)
    if llrs.device.type == "cuda":
        return _launch(code, llrs, maxiters, alpha)
    if llrs.device.type == "cpu":
        return layered_minsum_plain(qc_structure(code), llrs, maxiters, alpha)
    raise ValueError(f"layered_minsum takes CUDA or CPU tensors, got {llrs.device}")


def make_ms_decoder_cuda_layered(
    code: LDPCCode | str,
    maxiters: int = 20,
    alpha: float | None = None,
    device="cuda",
):
    """Row-layered self-corrected min-sum decoder through the CUDA kernel.

    Returns fn(llrs: (B, n) float32, bfloat16, int8 or int16) -> MSResult, run
    on `device`; `device="cpu"` runs the plain version. `alpha` needs float
    LLRs (a float32 alpha, as the TPU kernels', also for bfloat16).
    """
    code = get_code(code)
    dev = resolve_device(device)

    def decode(llrs) -> MSResult:
        return layered_minsum(code, torch.as_tensor(llrs, device=dev), maxiters, alpha)

    return decode
