"""Hand-written CUDA kernel for the flooding self-corrected min-sum decode.

Wraps `csrc/flooding_minsum.cu`, the Hopper port of the two TPU flooding
kernels (labrador_ldpc_tpu/ops/pallas_qc.py:265 make_ms_decoder_pallas_qc and
labrador_ldpc_tpu/ops/pallas_tc.py:506 make_ms_decoder_pallas_tc_qc), for all
nine codes, in float32 and bfloat16 (with alpha; bfloat16 storage, float32
arithmetic, as the TPU kernels) and in the saturating int8/int16 forms (one C
entry point per dtype). impl "cuda_qc" of the decoder registry.

On a CPU tensor the wrapper runs the plain version
(`qc_minsum.flooding_minsum_plain`); on a CUDA tensor it launches the kernel
or raises. `launches` counts kernel launches and nothing else;
`form_launches` splits the same count by dtype form ("f32", "bf16", "i8",
"i16"). float64 LLRs raise a ValueError, as the TPU kernels refuse them.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from ..codes.expand import qc_structure
from ..codes.params import LDPCCode, get_code
from ..device import resolve_device
from ._nvcc import load_library
from .cuda_layered import FORMS, addend_table, column_order
from .minsum import MSResult
from .qc_minsum import KERNEL_DTYPES, check_llrs, flooding_minsum_plain

__all__ = ["make_ms_decoder_cuda_qc", "flooding_minsum", "SOURCE"]

SOURCE = "flooding_minsum.cu"

# kernel launches since import; read and reset as `cuda_qc.launches`
launches = 0
# the same launches by dtype form; reset with `launches`
form_launches = dict.fromkeys(FORMS.values(), 0)


@lru_cache(maxsize=None)
def _device_tables(code: LDPCCode, device: torch.device) -> dict:
    s = qc_structure(code)
    # perm_index / perm_inverse reduce mod M and mod M/4 with masks
    if s.m & (s.m - 1) or s.m % 4:
        raise ValueError(f"the CUDA flooding kernel needs a power-of-two M, {code} has {s.m}")
    table, row_off = addend_table(s)
    col_edges, col_off = column_order(table, s.n_block_cols)
    as_dev = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return dict(table=as_dev(table), row_off=as_dev(row_off), col_edges=as_dev(col_edges),
                col_off=as_dev(col_off))


@lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for form in FORMS.values():
        fn = getattr(lib, f"flooding_minsum_{form}")
        fn.argtypes = [ptr] * 8 + [i32] * 8 + [ctypes.c_float, ptr]
        fn.restype = i32
    return lib


def _launch(code: LDPCCode, llrs: torch.Tensor, maxiters: int, alpha: float | None) -> MSResult:
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
    t = _device_tables(code, dev)
    form = FORMS[llrs.dtype]
    fn = getattr(_lib(), f"flooding_minsum_{form}")
    with torch.cuda.device(dev):
        err = fn(
            llrs.data_ptr(), bits.data_ptr(), success.data_ptr(), iterations.data_ptr(),
            t["table"].data_ptr(), t["row_off"].data_ptr(), t["col_edges"].data_ptr(),
            t["col_off"].data_ptr(), B, n, M, R, Cc, t["table"].shape[0], maxiters,
            0 if alpha is None else 1, 0.0 if alpha is None else float(alpha),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"flooding_minsum_{form} launch failed with CUDA error {err}")
    launches += 1
    form_launches[form] += 1
    return MSResult(success, iterations, bits)


def flooding_minsum(code: LDPCCode | str, llrs: torch.Tensor, maxiters: int,
                    alpha: float | None = None) -> MSResult:
    """Decode (B, n) float32, bfloat16, int8 or int16 LLRs where they lie: the
    kernel on CUDA, the plain version on the CPU."""
    code = get_code(code)
    check_llrs(llrs, code.n, alpha, KERNEL_DTYPES)
    if llrs.device.type == "cuda":
        return _launch(code, llrs, maxiters, alpha)
    if llrs.device.type == "cpu":
        return flooding_minsum_plain(qc_structure(code), llrs, maxiters, alpha)
    raise ValueError(f"flooding_minsum takes CUDA or CPU tensors, got {llrs.device}")


def make_ms_decoder_cuda_qc(
    code: LDPCCode | str,
    maxiters: int = 20,
    alpha: float | None = None,
    device="cuda",
):
    """Flooding self-corrected min-sum decoder through the CUDA kernel.

    Returns fn(llrs: (B, n) float32, bfloat16, int8 or int16) -> MSResult, run
    on `device`; `device="cpu"` runs the plain version. float32 is
    `make_ms_decoder_qc`'s function (bfloat16 too without alpha; with alpha
    the kernel keeps alpha in float32, as the TPU kernels), int8/int16
    `make_ms_decoder_qc_int`'s; `alpha` needs float LLRs.
    """
    code = get_code(code)
    dev = resolve_device(device)

    def decode(llrs) -> MSResult:
        return flooding_minsum(code, torch.as_tensor(llrs, device=dev), maxiters, alpha)

    return decode
