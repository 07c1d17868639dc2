"""Batched GF(2) systematic encoder.

PyTorch counterpart of `labrador_ldpc_tpu/ops/encoder.py`. The reference
encodes one codeword at a time with a bit-serial XOR-and-rotate loop over
the compact circulant generator (encoder.rs:190-252); here the whole batch
is ONE matmul against the expanded generator parity block:

    parity_bits = (data_bits @ G_parity) mod 2        # (B,k) @ (k,n-k)

The JAX package leaves this product to XLA outside any Pallas kernel, so the
port leaves it to `torch.matmul`. Operands are 0/1 float32 and the product
accumulates in float32: every partial sum is an integer <= k <= 4096 < 2^24,
so the result is exact. TF32 is switched off around the product all the same
(`torch.backends.cuda.matmul.allow_tf32 = False`), so exactness does not rest
on how the tensor cores round their inputs.
"""

from __future__ import annotations

from contextlib import contextmanager
from functools import lru_cache

import torch

from ..codes.expand import generator_parity_matrix
from ..codes.params import LDPCCode, get_code
from ..device import resolve_device
from .convert import pack_bits, unpack_bits

__all__ = ["encode_bits", "encode", "encode_onto", "make_encoder"]


@lru_cache(maxsize=None)
def _g_parity_f32(code: LDPCCode, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(generator_parity_matrix(code), device=device).to(torch.float32)


@contextmanager
def _exact_f32_matmul():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def encode_bits(code: LDPCCode | str, data_bits, device="cuda") -> torch.Tensor:
    """(B, k) data bits -> (B, n) codeword bits (systematic), uint8."""
    code = get_code(code)
    dev = resolve_device(device)
    bits = torch.as_tensor(data_bits, device=dev).to(torch.uint8)
    if bits.shape[-1] != code.k:
        raise ValueError(f"data bits must be (B, {code.k}), got {tuple(bits.shape)}")
    g = _g_parity_f32(code, dev)
    with _exact_f32_matmul():
        parity = torch.matmul(bits.to(torch.float32), g)
    parity = parity.to(torch.int32).bitwise_and_(1).to(torch.uint8)
    return torch.cat([bits, parity], dim=-1)


def encode(code: LDPCCode | str, data_bytes, device="cuda") -> torch.Tensor:
    """(B, k/8) packed data bytes -> (B, n/8) packed codeword bytes.

    Equivalent to the reference's `copy_encode` (encoder.rs:309-315) over a
    batch of codewords.
    """
    code = get_code(code)
    bits = unpack_bits(data_bytes, device)
    return pack_bits(encode_bits(code, bits, bits.device), bits.device)


def encode_onto(code: LDPCCode | str, codeword_bytes, device="cuda") -> torch.Tensor:
    """Encode reading the data already sitting in the codeword head.

    The counterpart of the reference's in-place `encode(&mut codeword)`
    (encoder.rs:293-307): the input is a (..., n/8) packed buffer whose head
    holds the data (tail contents ignored); the result is a new buffer of the
    same shape with the parity tail filled in. The input is not written.
    """
    code = get_code(code)
    p = code.params
    dev = resolve_device(device)
    buf = torch.as_tensor(codeword_bytes, dtype=torch.uint8, device=dev)
    if buf.shape[-1] != p.n // 8:
        raise ValueError(f"codeword buffer must be (B, {p.n // 8}) packed bytes")
    return encode(code, buf[..., : p.k // 8], dev)


def make_encoder(code: LDPCCode | str, packed: bool = True, device="cuda"):
    """Return a batched encoder for `code` on `device`.

    packed=True:  (B, k/8) uint8 -> (B, n/8) uint8
    packed=False: (B, k) bits    -> (B, n) bits
    """
    code = get_code(code)
    dev = resolve_device(device)
    fn = encode if packed else encode_bits

    def encoder(data):
        return fn(code, data, dev)

    return encoder
