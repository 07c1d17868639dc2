"""Bit packing and hard/soft conversion ops (batched).

PyTorch counterpart of `labrador_ldpc_tpu/ops/convert.py`, itself the
batched form of the reference's byte-oriented helpers:
  * hard_to_llrs (decoder.rs:484-493): bit 1 -> -1, bit 0 -> +1
  * llrs_to_hard (decoder.rs:498-509): sign -> MSB-first packed bits
plus MSB-first pack/unpack used throughout (the reference indexes bits as
`byte >> (7 - (bit % 8))`, i.e. MSB-first).
"""

from __future__ import annotations

import torch

from ..device import resolve_device

__all__ = ["unpack_bits", "pack_bits", "hard_to_llrs", "llrs_to_hard"]


def _shifts(device: torch.device) -> torch.Tensor:
    return torch.arange(7, -1, -1, dtype=torch.uint8, device=device)


def unpack_bits(data, device="cuda") -> torch.Tensor:
    """(..., nbytes) uint8 -> (..., nbytes*8) uint8 bits, MSB-first."""
    dev = resolve_device(device)
    data = torch.as_tensor(data, dtype=torch.uint8, device=dev)
    bits = (data[..., :, None] >> _shifts(dev)) & 1
    return bits.reshape(*data.shape[:-1], data.shape[-1] * 8)


def pack_bits(bits, device="cuda") -> torch.Tensor:
    """(..., n) bits (any integer/bool dtype) -> (..., n/8) uint8, MSB-first."""
    dev = resolve_device(device)
    bits = torch.as_tensor(bits, device=dev).to(torch.uint8)
    n = bits.shape[-1]
    if n % 8:
        raise ValueError(f"bit count must be a multiple of 8, got {n}")
    b = bits.reshape(*bits.shape[:-1], n // 8, 8)
    # each byte's 8 terms are disjoint powers of two: the sum is an OR and
    # fits uint8 exactly
    return (b << _shifts(dev)).sum(dim=-1, dtype=torch.uint8)


def hard_to_llrs(data, dtype=torch.float32, device="cuda") -> torch.Tensor:
    """(..., n/8) packed hard bytes -> (..., n) LLRs of +-1 in `dtype`."""
    bits = unpack_bits(data, device)
    one = torch.ones((), dtype=dtype, device=bits.device)
    return torch.where(bits == 1, -one, one)


def llrs_to_hard(llrs, device="cuda") -> torch.Tensor:
    """(..., n) LLRs -> (..., n/8) packed hard bytes (negative -> bit 1)."""
    dev = resolve_device(device)
    return pack_bits(torch.as_tensor(llrs, device=dev) < 0, dev)
