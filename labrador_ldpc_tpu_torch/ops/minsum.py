"""Min-sum result type, the gather tables and the `decode_ms` entry point.

PyTorch counterpart of part of `labrador_ldpc_tpu/ops/minsum.py`: the
`MSResult` fields, `_device_tables` (the gather tables over
`decoder_tables`, which the gather bit-flip and erasure decoders of
`ops/bitflip.py` use) and `decode_ms`. The reference-order decoder
(`make_ms_decoder`, gather-based over the same tables) comes with a later
slice (ROADMAP Queue A7).
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import torch

from ..codes.expand import decoder_tables
from ..codes.params import LDPCCode, get_code
from ..device import resolve_device

__all__ = ["decode_ms", "MSResult"]


class MSResult(NamedTuple):
    success: torch.Tensor  # (B,) bool — all parity checks satisfied
    iterations: torch.Tensor  # (B,) int32 — 0-based iteration of convergence, or maxiters
    bits: torch.Tensor  # (B, n+p) uint8 — hard-decoded marginals (data in first k)


@lru_cache(maxsize=None)
def _device_tables(code: LDPCCode, device: torch.device) -> dict:
    """`decoder_tables(code)` as tensors on `device`.

    Pad slots of `check_nbrs_flat` hold V and those of `var_check_idx` hold
    C: gathers read a sentinel row appended to the (V, B) or (C, B) plane,
    and the masks zero what they read there.
    """
    t = decoder_tables(code)
    return dict(
        check_nbrs_flat=torch.as_tensor(t.check_nbrs.reshape(-1), dtype=torch.int64, device=device),
        check_mask=torch.as_tensor(t.check_mask[:, :, None], dtype=torch.int32, device=device),
        var_check_idx=torch.as_tensor(t.var_check_idx, dtype=torch.int64, device=device),
        var_mask=torch.as_tensor(t.var_mask, dtype=torch.int32, device=device),
        meta=t,
    )


@lru_cache(maxsize=None)
def _cached_decoder(code: LDPCCode, dtype: torch.dtype, maxiters: int, alpha, impl: str,
                    device: torch.device):
    # lazy import: channel.awgn imports this module
    from ..channel.awgn import _make_decoder

    return _make_decoder(code, dtype, maxiters, alpha, impl, device)


def decode_ms(
    code: LDPCCode | str,
    llrs,
    maxiters: int = 20,
    alpha: float | None = None,
    impl: str = "auto",
    device="cuda",
) -> MSResult:
    """Batched min-sum decode of (B, n) LLRs on `device`.

    The decoder is built once per (code, dtype, maxiters, alpha, impl,
    device). `impl="auto"` resolves to the hand-written CUDA layered kernel
    on a CUDA device and to the plain PyTorch layered decoder on the CPU
    (`channel.awgn.resolve_impl`).
    """
    code = get_code(code)
    dev = resolve_device(device)
    llrs = torch.as_tensor(llrs, device=dev)
    from ..channel.awgn import resolve_impl

    impl = resolve_impl(code, llrs.dtype, impl, dev)
    return _cached_decoder(code, llrs.dtype, maxiters, alpha, impl, dev)(llrs)
