"""Decoder registry: `resolve_impl` and `_make_decoder`.

PyTorch counterpart of `labrador_ldpc_tpu/channel/awgn.py:34-188` for the
implementations this port has so far: "layered" (plain PyTorch) and
"cuda_layered" (the hand-written CUDA kernel), float32. The noise models,
trial steps and waterfall harness come with a later slice (ROADMAP Queue
A10). Every other impl or dtype raises a ValueError that names the slice
still to come, instead of failing deep inside a decoder.
"""

from __future__ import annotations

import torch

from ..codes.params import get_code
from ..device import resolve_device

__all__ = ["resolve_impl"]

IMPLS = ("auto", "layered", "cuda_layered")

# implementations of the JAX package that this port does not have yet
_LATER = {
    "ref": "the reference-order decoder comes with ROADMAP Queue A7",
    "qc": "flooding min-sum comes with ROADMAP Queue A7 (kernels B3/B4)",
    "qc_i8": "the saturating int flooding path comes with ROADMAP Queue A7",
    "qc_i16": "the saturating int flooding path comes with ROADMAP Queue A7",
    "pallas_qc": "the flooding kernel comes with ROADMAP Queue B3/B4",
    "pallas_layered": "is the TPU kernel; its CUDA port is impl='cuda_layered'",
    "sp": "sum-product comes with ROADMAP Queue A9",
    "sp_layered": "layered sum-product comes with ROADMAP Queue A9 (kernel B7)",
    "sp_pallas": "the sum-product kernel comes with ROADMAP Queue B7",
}


def _check_dtype(dtype: torch.dtype) -> None:
    if dtype == torch.float32:
        return
    if dtype in (torch.bfloat16, torch.int8, torch.int16):
        raise ValueError(
            f"{dtype} LLRs come with the main-path dtype slice (ROADMAP Queue A5); "
            "this port decodes float32"
        )
    if dtype in (torch.int32, torch.float64):
        raise ValueError(
            f"{dtype} LLRs need the reference-order decoder (ROADMAP Queue A7); "
            "this port decodes float32"
        )
    raise ValueError(f"unsupported LLR dtype {dtype}; this port decodes float32")


def resolve_impl(code, dtype, impl: str, device="cuda") -> str:
    """Resolve impl="auto" to a concrete implementation name.

    "auto" is the hand-written CUDA kernel on a CUDA device and the plain
    PyTorch layered decoder on the CPU. Concrete names pass through after
    the same checks, so callers can key caches on the resolved name.
    """
    get_code(code)
    _check_dtype(dtype)
    if impl in _LATER:
        raise ValueError(f"impl {impl!r} is not in this port yet: {impl} {_LATER[impl]}")
    if impl not in IMPLS:
        raise ValueError(f"unknown decoder impl {impl!r} ({'|'.join(IMPLS)})")
    if impl != "auto":
        return impl
    return "cuda_layered" if resolve_device(device).type == "cuda" else "layered"


def _make_decoder(code, dtype, maxiters, alpha, impl: str, device="cuda"):
    """Build the decoder for a (resolved or "auto") impl on `device`.

    "layered": plain PyTorch row-layered self-corrected min-sum;
    "cuda_layered": the same function through the CUDA kernel (its plain
    version on a CPU device). Returns fn(llrs: (B, n)) -> MSResult.
    """
    impl = resolve_impl(code, dtype, impl, device)
    if impl == "layered":
        from ..ops.qc_minsum import make_ms_decoder_layered

        return make_ms_decoder_layered(code, maxiters, alpha, device=device)
    from ..ops.cuda_layered import make_ms_decoder_cuda_layered

    return make_ms_decoder_cuda_layered(code, maxiters, alpha, device=device)
