"""Min-sum result type, the reference-order decoder and `decode_ms`.

PyTorch counterpart of `labrador_ldpc_tpu/ops/minsum.py`: the `MSResult`
fields, the saturating helpers of the reference's `DecodeFrom`
(decoder.rs:42-68), `_device_tables` (the gather tables over
`decoder_tables`, which the gather bit-flip and erasure decoders of
`ops/bitflip.py` use too), the reference-order decoder `make_ms_decoder`
(impl "ref") and `decode_ms`.

`make_ms_decoder` is the reference's flooding self-corrected min-sum
(decoder.rs:347-475) in its own edge order: every variable adds its check
messages in the reference's per-variable order with a saturating add after
each, so float32, int8, int16 and int32 give the JAX twin's results bit for
bit. bfloat16 and float64 compute plainly in their own dtype: every bfloat16
op rounds to bfloat16, as XLA's does, and alpha is itself a bfloat16. It is
plain PyTorch: the JAX package has no Pallas kernel for it and runs it outside
any kernel on the TPU too.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import torch

from ..codes.expand import decoder_tables
from ..codes.params import LDPCCode, get_code
from ..device import resolve_device
from ..utils.tracing import span, spanned

__all__ = ["decode_ms", "make_ms_decoder", "MSResult"]

# dtypes the saturating integer arithmetic of DecodeFrom covers
INT_DTYPES = (torch.int8, torch.int16, torch.int32)
FLOAT_DTYPES = (torch.float32, torch.bfloat16, torch.float64)
# LLR dtypes of the min-sum decoders in this port (the reference-order one
# takes them all)
DTYPES = (*FLOAT_DTYPES, *INT_DTYPES)


class MSResult(NamedTuple):
    success: torch.Tensor  # (B,) bool — all parity checks satisfied
    iterations: torch.Tensor  # (B,) int32 — 0-based iteration of convergence, or maxiters
    bits: torch.Tensor  # (B, n+p) uint8 — hard-decoded marginals (data in first k)


def _sat_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Saturating add, exact over the whole dtype range (decoder.rs:42-68).

    int8/int16 widen to int32 and clip; int32 detects overflow on the
    wrapping add (torch's int32 add wraps, as XLA's does): the operands share
    a sign and the wrapped sum's sign differs. Floats add plainly."""
    if a.dtype == torch.int32:
        s = a + b
        a_neg = a < 0
        ovf = (a_neg == (b < 0)) & ((s < 0) != a_neg)
        return torch.where(ovf, _bound(a_neg, a.dtype), s)
    if a.dtype in INT_DTYPES:
        info = torch.iinfo(a.dtype)
        return (a.to(torch.int32) + b.to(torch.int32)).clamp(info.min, info.max).to(a.dtype)
    return a + b


def _sat_sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Saturating sub; int32 overflows iff the operands' signs differ and the
    wrapped difference's sign differs from a's (see _sat_add)."""
    if a.dtype == torch.int32:
        s = a - b
        a_neg = a < 0
        ovf = (a_neg != (b < 0)) & ((s < 0) != a_neg)
        return torch.where(ovf, _bound(a_neg, a.dtype), s)
    if a.dtype in INT_DTYPES:
        info = torch.iinfo(a.dtype)
        return (a.to(torch.int32) - b.to(torch.int32)).clamp(info.min, info.max).to(a.dtype)
    return a - b


def _sat_abs(x: torch.Tensor) -> torch.Tensor:
    """Saturating abs: |INT_MIN| -> INT_MAX (decoder.rs:51-55)."""
    if x.dtype in INT_DTYPES:
        info = torch.iinfo(x.dtype)
        # abs(INT_MIN) wraps back to INT_MIN in every int dtype: guard it
        return torch.where(x == info.min, torch.tensor(info.max, dtype=x.dtype, device=x.device),
                           x.abs())
    return x.abs()


def _bound(neg: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The saturation value of an overflow: the dtype's min where `neg`, else its max."""
    info = torch.iinfo(dtype)
    lo = torch.tensor(info.min, dtype=dtype, device=neg.device)
    return torch.where(neg, lo, torch.tensor(info.max, dtype=dtype, device=neg.device))


def _maxval(dtype: torch.dtype):
    return torch.iinfo(dtype).max if dtype in INT_DTYPES else torch.finfo(dtype).max


def check_dtype(dtype: torch.dtype, supported: tuple) -> None:
    """Raise a ValueError for an LLR dtype outside `supported`."""
    if dtype in supported:
        return
    names = "/".join(str(d).removeprefix("torch.") for d in supported)
    raise ValueError(f"this decoder takes {names} LLRs, got {dtype}")


@lru_cache(maxsize=None)
def _device_tables(code: LDPCCode, device: torch.device) -> dict:
    """`decoder_tables(code)` as tensors on `device`.

    Pad slots of `check_nbrs_flat` hold V, those of `var_check_idx` hold C
    and those of `var_edge_idx` hold C*dc: gathers read a sentinel row
    appended to the (V, B), (C, B) or (C*dc, B) plane, and the masks zero
    what they read there (the sentinel of the edge plane is itself zero).
    """
    t = decoder_tables(code)
    return dict(
        check_nbrs_flat=torch.as_tensor(t.check_nbrs.reshape(-1), dtype=torch.int64, device=device),
        check_mask=torch.as_tensor(t.check_mask[:, :, None], dtype=torch.int32, device=device),
        var_edge_idx=torch.as_tensor(t.var_edge_idx, dtype=torch.int64, device=device),
        var_check_idx=torch.as_tensor(t.var_check_idx, dtype=torch.int64, device=device),
        var_mask=torch.as_tensor(t.var_mask, dtype=torch.int32, device=device),
        meta=t,
    )


def minsum_ref(code: LDPCCode, llrs: torch.Tensor, maxiters: int,
               alpha: float | None = None) -> MSResult:
    """Reference-order self-corrected min-sum of (B, n) LLRs on their own
    device, in their own dtype (any of `DTYPES`)."""
    dtype, dev = llrs.dtype, llrs.device
    tabs = _device_tables(code, dev)
    t = tabs["meta"]
    Cn, Vn, dc, dv = t.n_checks, t.n_vars, t.dc_max, t.dv_max
    B, n = llrs.shape
    check_nbrs_flat = tabs["check_nbrs_flat"]
    check_mask = tabs["check_mask"].bool()  # (C, dc, 1)
    var_edge_idx = tabs["var_edge_idx"]  # (V, dv)
    maxval = torch.tensor(_maxval(dtype), dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    alpha_t = None if alpha is None else torch.tensor(alpha, dtype=dtype, device=dev)
    slot = torch.arange(dc, device=dev)[None, :, None]

    llr_ext = torch.cat([llrs.t(), torch.zeros((Vn - n, B), dtype=dtype, device=dev)], dim=0)
    v = torch.zeros((Cn, dc, B), dtype=dtype, device=dev)
    min1 = torch.zeros((Cn, B), dtype=dtype, device=dev)  # decoder.rs:374 zeroes the working area
    min2 = torch.zeros((Cn, B), dtype=dtype, device=dev)
    sgn = torch.zeros((Cn, B), dtype=torch.bool, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    iters = torch.full((B,), maxiters, dtype=torch.int32, device=dev)
    va_out = llr_ext  # overwritten on the first iteration
    it = 0
    while it < maxiters and not bool(done.all()):
        # sweep 1: u[e] = +-(min1 or min2)[check] (decoder.rs:388-405)
        mag = torch.where(_sat_abs(v) == min1[:, None, :], min2[:, None, :], min1[:, None, :])
        if alpha_t is not None:
            mag = alpha_t * mag
        u = torch.where(sgn[:, None, :] ^ (v < 0), -mag, mag)  # (C, dc, B)
        # va = llr + the variable's messages in the reference's order, one
        # saturating add each (decoder.rs:408); the sentinel row is zero
        u_flat = torch.cat([u.reshape(Cn * dc, B), torch.zeros((1, B), dtype=dtype, device=dev)])
        va = llr_ext
        for j in range(dv):
            va = _sat_add(va, u_flat[var_edge_idx[:, j]])

        # sweep 2: v with self-correction (decoder.rs:420-426); check stats
        va_ext = torch.cat([va, torch.zeros((1, B), dtype=dtype, device=dev)])
        va_e = va_ext[check_nbrs_flat].reshape(Cn, dc, B)
        new_v = _sat_sub(va_e, u)
        keep = ((new_v < 0) == (v < 0)) | (v == 0)
        v = torch.where(keep, new_v, zero)
        a = torch.where(check_mask, _sat_abs(v), maxval)
        min1 = a.min(dim=1).values
        first = torch.where(a == min1[:, None, :], slot, dc).min(dim=1).values  # first on ties
        min2 = torch.where(slot == first[:, None, :], maxval, a).min(dim=1).values
        sgn = ((v < 0) & check_mask).sum(dim=1, dtype=torch.int32) % 2 == 1
        par = ((va_e < 0) & check_mask).sum(dim=1, dtype=torch.int32) % 2
        check_ok = (par == 0).all(dim=0)

        # freeze the marginals of each codeword at its convergence iteration
        newly_done = check_ok & ~done
        va_out = torch.where(done[None, :], va_out, va)
        iters = torch.where(newly_done, torch.full_like(iters, it), iters)
        done = done | check_ok
        it += 1

    bits = (va_out < 0).t().to(torch.uint8).contiguous()
    return MSResult(success=done, iterations=iters, bits=bits)


def make_ms_decoder(
    code: LDPCCode | str,
    maxiters: int = 20,
    alpha: float | None = None,
    device="cuda",
):
    """Reference-order self-corrected min-sum decoder (impl "ref").

    Returns fn(llrs: (B, n) float32, bfloat16, float64, int8, int16 or int32)
    -> MSResult, run on `device` in the LLRs' dtype; the int dtypes saturate at
    every add as the reference's DecodeFrom does. Positive LLRs favor bit 0.
    `alpha` (normalized min-sum) needs float LLRs.
    """
    code = get_code(code)
    dev = resolve_device(device)
    n = code.n

    def decode(llrs) -> MSResult:
        llrs = torch.as_tensor(llrs, device=dev)
        check_dtype(llrs.dtype, DTYPES)
        if alpha is not None and llrs.dtype in INT_DTYPES:
            raise ValueError("normalized min-sum (alpha) requires float LLRs")
        if llrs.ndim != 2 or llrs.shape[1] != n:
            raise ValueError(f"llrs must be (B, {n}), got {tuple(llrs.shape)}")
        return minsum_ref(code, llrs, maxiters, alpha)

    return decode


@lru_cache(maxsize=None)
def _cached_decoder(code: LDPCCode, dtype: torch.dtype, maxiters: int, alpha, impl: str,
                    device: torch.device):
    # lazy import: channel.awgn imports this module
    from ..channel.awgn import _make_decoder

    return _make_decoder(code, dtype, maxiters, alpha, impl, device)


@spanned("ldpc.decode_ms")
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
    device). `impl="auto"` resolves, for float32, bfloat16, int8 and int16
    LLRs, to the hand-written CUDA layered kernel on a CUDA device and to the
    plain PyTorch layered decoder on the CPU, for float64 (which no kernel
    takes) to the plain layered decoder everywhere, and for int32 to the
    reference-order decoder (`channel.awgn.resolve_impl`).

    Traced (`utils.tracing`): `ldpc.decode_ms` around the call, and inside it
    `ldpc.copy_in` (the LLRs moved to `device`) and `ldpc.decode`.
    """
    code = get_code(code)
    dev = resolve_device(device)
    with span("ldpc.copy_in"):
        llrs = torch.as_tensor(llrs, device=dev)
    from ..channel.awgn import resolve_impl

    with span("ldpc.decode"):
        impl = resolve_impl(code, llrs.dtype, impl, dev)
        return _cached_decoder(code, llrs.dtype, maxiters, alpha, impl, dev)(llrs)
