"""Hand-written CUDA kernel for the row-layered sum-product decode.

Wraps `csrc/sumproduct.cu`, the Hopper port of the TPU kernel
labrador_ldpc_tpu/ops/pallas_sp.py:48 make_sp_decoder_pallas, for all nine
codes, float32 only, on true channel LLRs. Impls "sp_layered" (on a CUDA
device) and "cuda_sp" (JAX's "sp_pallas") of the decoder registry.

On a CPU tensor the wrapper runs the plain version
(`sumproduct.layered_sp_plain`); on a CUDA tensor it launches the kernel or
raises. `launches` counts kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from ..codes.expand import qc_structure
from ..codes.params import LDPCCode, get_code
from ..device import resolve_device
from ._nvcc import load_library
from .cuda_layered import _device_tables
from .minsum import MSResult
from .sumproduct import check_sp_llrs, layered_sp_plain

__all__ = ["make_sp_decoder_cuda", "layered_sp", "launch_config", "SOURCE"]

SOURCE = "sumproduct.cu"

# kernel launches since import; read and reset as `cuda_sp.launches`
launches = 0


@lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.sumproduct_f32.argtypes = [ptr] * 6 + [i32] * 8 + [ptr]
    lib.sumproduct_f32.restype = i32
    lib.sumproduct_f32_config.argtypes = [i32] * 4 + [ctypes.POINTER(i32)] * 3
    lib.sumproduct_f32_config.restype = i32
    return lib


def _max_row(code: LDPCCode) -> int:
    """The widest block row's addend count: the rows of the layer buffer."""
    return max(len(row) for row in qc_structure(code).rows)


def launch_config(code: LDPCCode | str) -> dict:
    """The kernel's launch shape for `code` on the current card: threads and
    dynamic shared bytes per CTA, and the CTAs that fit on one SM."""
    code = get_code(code)
    s = qc_structure(code)
    sumA = sum(len(row) for row in s.rows)
    out = [ctypes.c_int() for _ in range(3)]
    err = _lib().sumproduct_f32_config(s.m, s.n_block_cols, sumA, _max_row(code),
                                       *(ctypes.byref(x) for x in out))
    if err != 0:
        raise RuntimeError(f"sumproduct_f32_config failed with CUDA error {err}")
    return dict(zip(("threads", "smem_bytes", "ctas_per_sm"), (x.value for x in out)))


def _launch(code: LDPCCode, llrs: torch.Tensor, maxiters: int) -> MSResult:
    global launches
    s = qc_structure(code)
    M, R, Cc = s.m, s.n_block_rows, s.n_block_cols
    B, n = llrs.shape
    dev = llrs.device
    llrs = llrs.contiguous()
    bits = torch.empty((B, Cc * M), dtype=torch.uint8, device=dev)
    success = torch.empty((B,), dtype=torch.bool, device=dev)
    iterations = torch.empty((B,), dtype=torch.int32, device=dev)
    if B == 0:
        return MSResult(success, iterations, bits)
    table, off = _device_tables(code, dev)
    with torch.cuda.device(dev):
        err = _lib().sumproduct_f32(
            llrs.data_ptr(), bits.data_ptr(), success.data_ptr(), iterations.data_ptr(),
            table.data_ptr(), off.data_ptr(), B, n, M, R, Cc, table.shape[0], _max_row(code),
            maxiters, torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"sumproduct_f32 launch failed with CUDA error {err}")
    launches += 1
    return MSResult(success, iterations, bits)


def layered_sp(code: LDPCCode | str, llrs: torch.Tensor, maxiters: int) -> MSResult:
    """Decode (B, n) float32 true LLRs where they lie: the kernel on CUDA, the
    plain version on the CPU."""
    code = get_code(code)
    check_sp_llrs(llrs, code.n)
    if llrs.device.type == "cuda":
        return _launch(code, llrs, maxiters)
    if llrs.device.type == "cpu":
        return layered_sp_plain(qc_structure(code), llrs, maxiters)
    raise ValueError(f"layered_sp takes CUDA or CPU tensors, got {llrs.device}")


def make_sp_decoder_cuda(code: LDPCCode | str, maxiters: int = 100, device="cuda"):
    """Row-layered sum-product decoder through the CUDA kernel.

    Returns fn(llrs: (B, n) float32 true LLRs) -> MSResult, run on `device`;
    `device="cpu"` runs the plain version. The function of
    `make_sp_decoder_layered`.
    """
    code = get_code(code)
    dev = resolve_device(device)

    def decode(llrs) -> MSResult:
        return layered_sp(code, torch.as_tensor(llrs, device=dev), maxiters)

    return decode
