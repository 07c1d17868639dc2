"""Batched hard-decision decoders: Gallager bit-flipping and erasure repair.

PyTorch counterpart of `labrador_ldpc_tpu/ops/bitflip.py`, itself the
batched form of the reference's `decode_bf` (decoder.rs:243-301) and its
punctured-bit erasure preprocessor `decode_erasures` (decoder.rs:144-223).
State is node-major: (nodes, B) integer planes.

  * check parity     = XOR over a check's neighbours of the current bits
  * violation counts = per variable, the number of its checks in violation
  * flip rule        = flip ALL variables whose count equals the codeword's
                       maximum (decoder.rs:288-296), all at once

Two formulations compute the same function:
  * `make_bf_decoder`: gathers over `decoder_tables` (the JAX gather form);
  * `make_bf_decoder_qc` / `bitflip_plain`: block permutations
    (`qc_minsum.perm_rows`) over the QC structure. `bitflip_plain` is the
    plain version of the CUDA kernel in `ops/cuda_bf.py`.

Punctured (TM) codes first run one erasure voting pass over the punctured
tail, and only when maxiters > 0: with maxiters == 0 the JAX twins run none
and return the tail as zeros (the TPU kernels run it regardless; the port
follows the twins). The pass adds 0 to `iterations` (the reference's
`bits_fixed` quirk: it reports success at iteration 0).
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import torch

from ..codes.expand import QCStructure, qc_structure
from ..codes.params import LDPCCode, get_code
from ..device import resolve_device
from .minsum import _device_tables
from .qc_minsum import perm_rows

__all__ = [
    "BFResult", "bitflip_plain", "decode_bf", "decode_erasures_bits", "decode_erasures_mask",
    "make_bf_decoder", "make_bf_decoder_qc",
]

_I32 = torch.int32


class BFResult(NamedTuple):
    success: torch.Tensor  # (B,) bool
    iterations: torch.Tensor  # (B,) int32 (the erasure pass adds 0)
    bits: torch.Tensor  # (B, n+p) uint8 decoded codeword bits


def _hard_input(hard_bits, n: int, device: torch.device) -> torch.Tensor:
    """(B, n) 0/1 hard bits of any integer or bool dtype, as uint8 on `device`."""
    hard_bits = torch.as_tensor(hard_bits, device=device)
    if hard_bits.dtype.is_floating_point or hard_bits.dtype.is_complex:
        raise ValueError(f"hard bits must be an integer or bool tensor, got {hard_bits.dtype}")
    if hard_bits.ndim != 2 or hard_bits.shape[1] != n:
        raise ValueError(f"hard_bits must be (B, {n}), got {tuple(hard_bits.shape)}")
    return hard_bits.to(torch.uint8)


def _with_sentinel(x: torch.Tensor) -> torch.Tensor:
    """(N, B) -> (N+1, B) int32 with a zero row that the tables' pad slots read."""
    return torch.cat([x.to(_I32), x.new_zeros((1, x.shape[1]), dtype=_I32)], dim=0)


def _check_parity(bits_ext, check_nbrs_flat, check_mask, Cn: int, dc: int) -> torch.Tensor:
    """bits_ext: (V+1, B) int32 with sentinel row -> (C, B) parity (0/1)."""
    g = bits_ext.index_select(0, check_nbrs_flat).reshape(Cn, dc, -1)
    return (g * check_mask).sum(dim=1, dtype=_I32) & 1


def _var_sum(check_vals_ext, tabs) -> torch.Tensor:
    """(C+1, B) per-check values with sentinel row -> (V, B) sums over each
    variable's checks."""
    vci = tabs["var_check_idx"]
    g = check_vals_ext.index_select(0, vci.reshape(-1)).reshape(*vci.shape, -1)
    return (g * tabs["var_mask"][:, :, None]).sum(dim=1, dtype=_I32)


def _erasure_pass(bits_t, erased_t, tabs):
    """One voting iteration of the erasure decoder (decoder.rs:172-218).

    bits_t (V, B) int32, erased_t (V, B) bool. Checks with exactly one
    erased neighbour vote +1 (parity of their other bits 1) or -1 on it;
    erased variables with a positive total become 1 and are unmarked.
    Returns the updated (bits_t, erased_t).
    """
    t = tabs["meta"]
    Cn, dc = t.n_checks, t.dc_max
    nbrs, cmask = tabs["check_nbrs_flat"], tabs["check_mask"]
    B = bits_t.shape[-1]
    e_g = _with_sentinel(erased_t).index_select(0, nbrs).reshape(Cn, dc, B) * cmask
    b_g = _with_sentinel(bits_t).index_select(0, nbrs).reshape(Cn, dc, B) * cmask
    ecount = e_g.sum(dim=1, dtype=_I32)
    parity = (b_g * (1 - e_g)).sum(dim=1, dtype=_I32) & 1  # non-erased bits only
    vote_val = torch.where(parity == 1, 1, -1).to(_I32) * (ecount == 1)
    votes = _var_sum(_with_sentinel(vote_val), tabs) * erased_t
    fix = erased_t & (votes > 0)
    return torch.where(fix, 1, bits_t).to(_I32), erased_t & ~fix


def decode_erasures_bits(code: LDPCCode | str, bits, maxiters: int = 20, device="cuda"):
    """Repair the punctured bits of hard codewords.

    bits: (B, n+p) with the first n columns set (the punctured tail is
    ignored). Returns (success (B,), iters (B,), bits (B, n+p) uint8). Keeps
    the reference's accounting: success fires when the accumulated
    still-erased count reaches p, which happens at the end of iteration 0
    whenever maxiters > 0, so at most one pass runs.
    """
    code = get_code(code)
    p = code.params
    dev = resolve_device(device)
    n, Vn, pb = p.n, p.n_vars, p.punctured_bits
    if pb == 0:
        raise ValueError("decode_erasures only applies to punctured (TM) codes")
    bits = torch.as_tensor(bits, device=dev)
    if bits.ndim != 2 or bits.shape[1] != Vn:
        raise ValueError(f"bits must be (B, {Vn}), got {tuple(bits.shape)}")
    tabs = _device_tables(code, dev)
    B = bits.shape[0]
    bits_t = bits.to(_I32).t().clone()
    bits_t[n:] = 0
    erased_t = torch.zeros((Vn, B), dtype=torch.bool, device=dev)
    erased_t[n:] = True
    success = torch.zeros((B,), dtype=torch.bool, device=dev)
    iters = torch.full((B,), maxiters, dtype=_I32, device=dev)
    if maxiters > 0:
        # the accumulated count reaches p at iteration 0 for every codeword
        # (reference quirk, decoder.rs:205-218): one pass in total
        still = erased_t[n:].sum(dim=0, dtype=_I32)
        bits_t, erased_t = _erasure_pass(bits_t, erased_t, tabs)
        success = still == pb
        iters = torch.where(success, 0, iters).to(_I32)
    return success, iters, bits_t.t().to(torch.uint8).contiguous()


def decode_erasures_mask(code: LDPCCode | str, bits, erased, maxiters: int = 32, device="cuda"):
    """Erasure decoder over an explicit per-bit erasure mask.

    The reference hardwires the erased set to the punctured tail; this
    generalisation (the JAX package's, not a reference-parity surface)
    takes any mask and iterates the same voting rule to a fixpoint or
    `maxiters` passes. Residual erased bits stay 0.

    bits/erased: (B, n+p). Returns (still_erased (B,) int32 counts, iters
    (B,) int32 index of the first pass that resolved nothing, bits (B, n+p)
    uint8).
    """
    code = get_code(code)
    dev = resolve_device(device)
    Vn = code.params.n_vars
    bits = torch.as_tensor(bits, device=dev)
    erased = torch.as_tensor(erased, device=dev)
    if bits.ndim != 2 or bits.shape[1] != Vn or erased.shape != bits.shape:
        raise ValueError(
            f"bits and erased must both be (B, {Vn}), got {tuple(bits.shape)} and "
            f"{tuple(erased.shape)}"
        )
    tabs = _device_tables(code, dev)
    erased_t = erased.to(torch.bool).t()
    bits_t = torch.where(erased_t, 0, bits.to(_I32).t()).to(_I32)
    B = bits_t.shape[-1]
    iters = torch.full((B,), maxiters, dtype=_I32, device=dev)
    fixed = torch.zeros((B,), dtype=torch.bool, device=dev)
    for it in range(maxiters):
        if bool(fixed.all()):
            break  # a pass over a fixpoint changes nothing
        bits_t, new_erased = _erasure_pass(bits_t, erased_t, tabs)
        newly = ~(new_erased != erased_t).any(dim=0) & ~fixed
        iters = torch.where(newly, it, iters).to(_I32)
        fixed = fixed | newly
        erased_t = new_erased
    return erased_t.sum(dim=0, dtype=_I32), iters, bits_t.t().to(torch.uint8).contiguous()


def make_bf_decoder(code: LDPCCode | str, maxiters: int = 20, device="cuda"):
    """Batched bit-flip decoder, gather form over `decoder_tables`.

    Returns fn(hard_bits: (B, n) 0/1 integers) -> BFResult, run on `device`.
    """
    code = get_code(code)
    p = code.params
    dev = resolve_device(device)
    tabs = _device_tables(code, dev)
    t = tabs["meta"]
    Cn, Vn, dc, n = t.n_checks, t.n_vars, t.dc_max, p.n

    def decode(hard_bits) -> BFResult:
        hard = _hard_input(hard_bits, n, dev)
        B = hard.shape[0]
        bits_full = torch.cat([hard.to(_I32), hard.new_zeros((B, Vn - n), dtype=_I32)], dim=1)
        erasure_iters = torch.zeros((B,), dtype=_I32, device=dev)
        bits_t = bits_full.t()
        if p.punctured_bits > 0:
            _, erasure_iters, fixed = decode_erasures_bits(code, bits_full, maxiters, dev)
            bits_t = fixed.to(_I32).t()
        done = torch.zeros((B,), dtype=torch.bool, device=dev)
        iters = torch.full((B,), maxiters, dtype=_I32, device=dev)
        it = 0
        while it < maxiters and not bool(done.all()):
            par = _check_parity(_with_sentinel(bits_t), tabs["check_nbrs_flat"],
                                tabs["check_mask"], Cn, dc)
            viol = _var_sum(_with_sentinel(par), tabs)
            mx = viol.amax(dim=0)
            check_ok = mx == 0
            flip = (viol == mx) & (mx > 0) & ~done
            bits_t = torch.where(flip, bits_t ^ 1, bits_t)
            iters = torch.where(check_ok & ~done, it, iters).to(_I32)
            done = done | check_ok
            it += 1
        return BFResult(done, iters + erasure_iters, bits_t.t().to(torch.uint8).contiguous())

    return decode


def bitflip_plain(s: QCStructure, hard_bits: torch.Tensor, maxiters: int) -> BFResult:
    """Decode (B, n) uint8 hard bits on their own device over the QC block
    structure. The plain version of the CUDA kernel (csrc/bitflip.cu)."""
    M, Cc = s.m, s.n_block_cols
    B, n = hard_bits.shape
    dev = hard_bits.device
    bits0 = torch.zeros((Cc * M, B), dtype=torch.uint8, device=dev)
    bits0[:n] = hard_bits.t()  # punctured tail = 0
    blocks = list(bits0.split(M))

    def row_parity(row) -> torch.Tensor:
        par = torch.zeros((M, B), dtype=torch.uint8, device=dev)
        for perm in row:
            par = par ^ perm_rows(blocks[perm.col], perm)
        return par

    if maxiters > 0 and Cc * M > n:
        # one erasure voting pass over the punctured tail: per check, the
        # number of erased neighbours is a sum of permuted erased masks;
        # checks with exactly one vote +1 (parity 1) or -1 on it
        node = torch.arange(M, device=dev)
        erased = [node + c * M >= n for c in range(Cc)]
        votes = [torch.zeros((M, B), dtype=_I32, device=dev) for _ in range(Cc)]
        for row in s.rows:
            ecount = sum(perm_rows(erased[perm.col].to(_I32), perm) for perm in row)
            vote = torch.where(row_parity(row) == 1, 1, -1).to(_I32) * (ecount == 1)[:, None]
            for perm in row:
                votes[perm.col] = votes[perm.col] + perm_rows(vote, perm, inverse=True)
        blocks = [
            torch.where(erased[c][:, None] & (votes[c] > 0), 1, blocks[c]).to(torch.uint8)
            for c in range(Cc)
        ]

    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    iters = torch.full((B,), maxiters, dtype=_I32, device=dev)
    it = 0
    while it < maxiters and not bool(done.all()):
        # violation counts: each row's parity scattered back through each of
        # its addends (two addends of one row may share a block column)
        viol = [torch.zeros((M, B), dtype=_I32, device=dev) for _ in range(Cc)]
        for row in s.rows:
            par = row_parity(row).to(_I32)
            for perm in row:
                viol[perm.col] = viol[perm.col] + perm_rows(par, perm, inverse=True)
        mx = torch.stack([v.amax(dim=0) for v in viol]).amax(dim=0)  # (B,)
        check_ok = mx == 0
        live = ((mx > 0) & ~done)[None, :]
        blocks = [torch.where((viol[c] == mx) & live, blocks[c] ^ 1, blocks[c]) for c in range(Cc)]
        iters = torch.where(check_ok & ~done, it, iters).to(_I32)
        done = done | check_ok
        it += 1
    return BFResult(done, iters, torch.cat(blocks).t().contiguous())


def make_bf_decoder_qc(code: LDPCCode | str, maxiters: int = 20, device="cuda"):
    """Bit-flip decoder over the QC block structure (plain PyTorch).

    The same function as `make_bf_decoder`, bit for bit. Returns
    fn(hard_bits: (B, n) 0/1 integers) -> BFResult, run on `device`.
    """
    code = get_code(code)
    dev = resolve_device(device)
    s = qc_structure(code)

    def decode(hard_bits) -> BFResult:
        return bitflip_plain(s, _hard_input(hard_bits, code.n, dev), maxiters)

    return decode


@lru_cache(maxsize=None)
def _cached_bf(code: LDPCCode, maxiters: int, device: torch.device):
    # lazy import: channel.hard imports this module
    from ..channel.hard import _make_bf_decoder, resolve_bf_impl

    return _make_bf_decoder(code, maxiters, resolve_bf_impl(code, "auto", device), device)


def decode_bf(code: LDPCCode | str, hard_bits, maxiters: int = 20, device="cuda") -> BFResult:
    """Batched bit-flip decode of (B, n) hard bits on `device`: the CUDA
    kernel on a CUDA device, the plain QC version on the CPU."""
    return _cached_bf(get_code(code), maxiters, resolve_device(device))(hard_bits)
