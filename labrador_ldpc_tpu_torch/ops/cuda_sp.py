"""Hand-written CUDA kernel for the row-layered sum-product decode.

Wraps `csrc/sumproduct.cu`, the Hopper port of the TPU kernel
labrador_ldpc_tpu/ops/pallas_sp.py:48 make_sp_decoder_pallas, for all nine
codes, float32 only, on true channel LLRs. Impls "sp_layered" (on a CUDA
device) and "cuda_sp" (JAX's "sp_pallas") of the decoder registry.

On a CPU tensor the wrapper runs the plain version
(`sumproduct.layered_sp_plain`); on a CUDA tensor it launches the kernel or
raises. `launches` counts kernel launches and nothing else.

The kernel keeps a codeword's posteriors and check messages in shared memory
and allocates nothing; the wrapper allocates the outputs only. Its launch
shape comes from `launch_config` (plain Python, no card needed), and the
addend table from `cuda_layered.addend_descriptors`, as for the layered
min-sum kernel; the C side checks both against the code.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from ..codes.expand import qc_structure
from ..codes.params import LDPCCode, get_code
from ..device import resolve_device
from ._nvcc import load_library
from .cuda_layered import (CTA_RESERVED_BYTES, CTA_SHARED_MAX, MAX_CTAS_PER_SM, SM_SHARED_BYTES,
                           _kernel_tables, _shape)
from .minsum import MSResult
from .routing import route_for
from .sumproduct import check_sp_llrs, layered_sp_plain

__all__ = ["make_sp_decoder_cuda", "layered_sp", "launch_config", "card_ctas_per_sm",
           "ctas_per_sm", "INSTANCES", "SOURCE"]

SOURCE = "sumproduct.cu"

# the kernel's instances, by the widest row of a code: checks a thread, two
# where a layer has more checks than a CTA threads (TM8192, and TM2048 with
# it), else one, which runs the most threads an SM
INSTANCES = {6: 2, 8: 1, 10: 1, 18: 1}

# H100 (sm_90) limits the occupancy calculator applies besides shared memory:
# an SM's registers come in four sub-partitions, a warp takes whole units of
# 256 registers from one of them
SUB_PARTITION_REGISTERS = 16_384
SUB_PARTITIONS = 4
REGISTER_UNIT = 256
MAX_WARPS_PER_SM = 64
# the kernel's register budget, __launch_bounds__(1024): 64 a thread
REGISTERS_PER_THREAD = 64

# kernel launches since import; read and reset as `cuda_sp.launches`
launches = 0


@lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.sumproduct_f32.argtypes = [ptr] * 6 + [i32] * 11 + [ptr]
    lib.sumproduct_f32.restype = i32
    lib.sumproduct_f32_config.argtypes = [i32] * 8 + [ctypes.POINTER(i32)]
    lib.sumproduct_f32_config.restype = i32
    return lib


def launch_config(code: LDPCCode | str, registers: int = REGISTERS_PER_THREAD) -> dict:
    """The kernel's launch shape for `code` on an H100: threads and checks a
    thread per CTA (one CTA per codeword, one owner thread per check), its
    dynamic shared bytes, and the CTAs that fit on one SM when a thread takes
    `registers` registers (the kernel's budget by default; ptxas's count of
    the instance gives the card's).

    Shared bytes: the posteriors (Cc*M floats) and every edge's u (sumA*M
    floats); the layer's phi values live in the owners' registers. The CTAs
    an SM holds are the fewest that shared memory, registers, 64 warps and
    32 CTAs allow."""
    code = get_code(code)
    M, _, Cc, sumA, row_max = _shape(code)
    if row_max not in INSTANCES:
        raise ValueError(f"{code}: no kernel instance for rows of {row_max} addends")
    checks = INSTANCES[row_max]
    threads = max(32, M // checks)  # below 32 checks: one warp, lanes past M idle
    smem = (Cc + sumA) * M * 4
    if smem > CTA_SHARED_MAX:
        raise ValueError(f"{code} needs {smem} B of shared memory, over {CTA_SHARED_MAX}")
    return dict(threads=threads, checks_per_thread=checks, smem_bytes=smem,
                ctas_per_sm=ctas_per_sm(smem, threads, registers))


def ctas_per_sm(smem: int, threads: int, registers: int) -> int:
    """The CTAs of `threads` threads, `smem` dynamic shared bytes and
    `registers` registers a thread that fit on one H100 SM: the fewest that
    shared memory, the register file, 64 warps and 32 CTAs allow."""
    warps = threads // 32
    per_warp = -(-registers * 32 // REGISTER_UNIT) * REGISTER_UNIT
    reg_warps = SUB_PARTITION_REGISTERS // per_warp * SUB_PARTITIONS
    return min(MAX_CTAS_PER_SM, SM_SHARED_BYTES // (smem + CTA_RESERVED_BYTES),
               MAX_WARPS_PER_SM // warps, reg_warps // warps)


def card_ctas_per_sm(code: LDPCCode | str) -> int:
    """The CTAs of `launch_config(code)` that fit on one SM of the current
    card, as the CUDA runtime's occupancy calculator reports them."""
    code = get_code(code)
    cfg = launch_config(code)
    out = ctypes.c_int()
    err = _lib().sumproduct_f32_config(*_shape(code), cfg["threads"], cfg["checks_per_thread"],
                                       cfg["smem_bytes"], ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"sumproduct_f32_config failed with CUDA error {err}")
    return out.value


def _launch(code: LDPCCode, llrs: torch.Tensor, maxiters: int) -> MSResult:
    global launches
    M, R, Cc, sumA, row_max = _shape(code)
    B, n = llrs.shape
    dev = llrs.device
    llrs = llrs.contiguous()
    bits = torch.empty((B, Cc * M), dtype=torch.uint8, device=dev)
    success = torch.empty((B,), dtype=torch.bool, device=dev)
    iterations = torch.empty((B,), dtype=torch.int32, device=dev)
    if B == 0:
        return MSResult(success, iterations, bits)
    desc, off = _kernel_tables(code, dev)
    cfg = launch_config(code)
    with torch.cuda.device(dev):
        err = _lib().sumproduct_f32(
            llrs.data_ptr(), bits.data_ptr(), success.data_ptr(), iterations.data_ptr(),
            desc.data_ptr(), off.data_ptr(), B, n, M, R, Cc, sumA, row_max, maxiters,
            cfg["threads"], cfg["checks_per_thread"], cfg["smem_bytes"],
            torch.cuda.current_stream(dev).cuda_stream,
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
    route_for(code)  # an unrouted code fails here, before any launch
    dev = resolve_device(device)

    def decode(llrs) -> MSResult:
        return layered_sp(code, torch.as_tensor(llrs, device=dev), maxiters)

    return decode
