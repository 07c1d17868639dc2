"""Sum-product (belief propagation) decoders, float32, plain PyTorch.

PyTorch counterpart of `labrador_ldpc_tpu/ops/sumproduct.py`. The reference
says its min-sum decoder "performs very close to the optimal sum-product
algorithm" (src/lib.rs:217-218) but ships none; these decoders are that
yardstick and the JAX package's quality path. The check update is the phi
rule, with |t| clamped to [PHI_EPS, PHI_CLIP] (phi(0) = inf):

    |u_e| = phi( sum_{e' != e} phi(|t_e'|) ),  phi(x) = -ln tanh(x/2)
    sign(u_e) = XOR of the other edges' signs (t < 0; -0.0 counts as positive)

  * `make_sp_decoder`: flooding BP over the gather tables of
    `ops/minsum._device_tables` (v_e = va - u_e, va = llr + sum u). The JAX
    package runs it outside any kernel, so it stays plain PyTorch on every
    device.
  * `make_sp_decoder_layered` on `layered_sp_plain`: the row-layered schedule
    of `qc_minsum.layered_minsum_plain` with the phi rule, no
    self-correction and no t' plane. It is the twin of the TPU kernel
    labrador_ldpc_tpu/ops/pallas_sp.py:48 and the plain version of the CUDA
    kernel in `ops/cuda_sp.py`.

Both take TRUE channel LLRs 2y/sigma^2: BP is not scale-invariant, unlike
min-sum (decoder.rs:332-335). Same conventions as the min-sum decoders:
positive LLR -> bit 0, punctured tail LLR 0, early exit on the syndrome,
iterations 0-based at convergence.

phi keeps the JAX package's exp/log expression (no tanh, log1p or expm1), so
the CUDA kernel, which spells out the same float32 operations with expf and
logf, can match this module on the card. PyTorch's CPU exp/log are not XLA's,
so on the CPU this module agrees with the JAX twins in decode outcomes, not
bit for bit (tests/test_torch_sumproduct.py states the tolerances).
"""

from __future__ import annotations

import torch

from ..codes.expand import QCStructure, qc_structure
from ..codes.params import LDPCCode, get_code
from ..device import resolve_device
from .minsum import MSResult, _device_tables
from .qc_minsum import _freeze, _llr_blocks, _row_offsets, perm_rows

__all__ = ["make_sp_decoder", "make_sp_decoder_layered", "layered_sp_plain", "flooding_sp_plain",
           "PHI_EPS", "PHI_CLIP"]

PHI_EPS = 1e-6
PHI_CLIP = 25.0


def _phi(x: torch.Tensor) -> torch.Tensor:
    """-ln tanh(x/2) for x clamped into [PHI_EPS, PHI_CLIP], as
    log((1 + e^-x) / (1 - e^-x)); phi is its own inverse."""
    x = torch.clamp(x, PHI_EPS, PHI_CLIP)
    em = torch.exp(-x)
    return torch.log((1.0 + em) / (1.0 - em))


def check_sp_llrs(llrs: torch.Tensor, n: int) -> None:
    """Raise a ValueError unless llrs is (B, n) float32."""
    if llrs.dtype != torch.float32:
        raise ValueError(f"the sum-product decoders take float32 LLRs, got {llrs.dtype}")
    if llrs.ndim != 2 or llrs.shape[1] != n:
        raise ValueError(f"llrs must be (B, {n}), got {tuple(llrs.shape)}")


def flooding_sp_plain(code: LDPCCode, llrs: torch.Tensor, maxiters: int) -> MSResult:
    """Flooding BP of (B, n) float32 true LLRs on their own device."""
    dev = llrs.device
    tabs = _device_tables(code, dev)
    t = tabs["meta"]
    Cn, Vn, dc, dv = t.n_checks, t.n_vars, t.dc_max, t.dv_max
    B, n = llrs.shape
    check_nbrs_flat = tabs["check_nbrs_flat"]  # (C*dc,) in [0, V]
    check_mask = tabs["check_mask"].bool()  # (C, dc, 1)
    var_edge_idx = tabs["var_edge_idx"]  # (V, dv) in [0, C*dc]
    zero_row = torch.zeros((1, B), dtype=torch.float32, device=dev)

    llr_ext = torch.cat([llrs.t(), torch.zeros((Vn - n, B), dtype=torch.float32, device=dev)])
    # v starts at the channel LLRs (standard BP init): v_e = llr[var]
    v = torch.cat([llr_ext, zero_row])[check_nbrs_flat].reshape(Cn, dc, B)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    iters = torch.full((B,), maxiters, dtype=torch.int32, device=dev)
    va_out = llr_ext
    it = 0
    while it < maxiters and not bool(done.all()):
        # check update: phi rule, leave-one-out over the check's edges
        phis = torch.where(check_mask, _phi(v.abs()), 0.0)
        phi_sum = phis.sum(dim=1, keepdim=True)
        mag = _phi(phi_sum - phis)
        neg = (v < 0.0) & check_mask
        sgn_tot = neg.sum(dim=1, dtype=torch.int32) & 1  # (C, B)
        sign_e = (sgn_tot[:, None, :] == 1) ^ neg
        u = torch.where(check_mask, torch.where(sign_e, -mag, mag), 0.0)

        # variable update: va = llr + the variable's messages in table order
        u_flat = torch.cat([u.reshape(Cn * dc, B), zero_row])
        va = llr_ext
        for j in range(dv):
            va = va + u_flat[var_edge_idx[:, j]]
        va_e = torch.cat([va, zero_row])[check_nbrs_flat].reshape(Cn, dc, B)
        v = va_e - u

        # syndrome on this iteration's posteriors; freeze at convergence
        par = ((va_e < 0.0) & check_mask).sum(dim=1, dtype=torch.int32) & 1
        check_ok = (par == 0).all(dim=0)
        newly_done = check_ok & ~done
        va_out = torch.where(done[None, :], va_out, va)
        iters = torch.where(newly_done, torch.full_like(iters, it), iters)
        done = done | check_ok
        it += 1

    bits = (va_out < 0.0).t().to(torch.uint8).contiguous()
    return MSResult(success=done, iterations=iters, bits=bits)


def layered_sp_plain(s: QCStructure, llrs: torch.Tensor, maxiters: int) -> MSResult:
    """Row-layered BP of (B, n) float32 true LLRs on their own device."""
    M, Cc = s.m, s.n_block_cols
    B = llrs.shape[0]
    dev = llrs.device
    va = _llr_blocks(s, llrs, torch.float32)
    row_off = _row_offsets(s)
    us = [torch.zeros((M, B), dtype=torch.float32, device=dev) for _ in range(row_off[-1])]
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    iters = torch.full((B,), maxiters, dtype=torch.int32, device=dev)
    bits = torch.zeros((Cc * M, B), dtype=torch.bool, device=dev)

    it = 0
    while it < maxiters and not bool(done.all()):
        for r, row in enumerate(s.rows):
            # extrinsics t = perm(va) - u_old over the layer; phi sum and sign
            # product accumulate from the first addend, in addend order
            ts = [perm_rows(va[perm.col], perm) - us[row_off[r] + a] for a, perm in enumerate(row)]
            phis = [_phi(t.abs()) for t in ts]
            phi_sum = phis[0]
            for ph in phis[1:]:
                phi_sum = phi_sum + ph
            sg = ts[0] < 0.0
            for t in ts[1:]:
                sg = sg ^ (t < 0.0)
            # new u; va[col] <- va[col] + perm_inv(u - u_old), addend by addend
            for a, perm in enumerate(row):
                e = row_off[r] + a
                mag = _phi(phi_sum - phis[a])
                u = torch.where(sg ^ (ts[a] < 0.0), -mag, mag)
                va[perm.col] = va[perm.col] + perm_rows(u - us[e], perm, inverse=True)
                us[e] = u

        # end-of-iteration syndrome over the final posteriors
        signs = [va[c] < 0.0 for c in range(Cc)]
        ok = torch.ones((B,), dtype=torch.bool, device=dev)
        for row in s.rows:
            par = torch.zeros((M, B), dtype=torch.bool, device=dev)
            for perm in row:
                par = par ^ perm_rows(signs[perm.col], perm)
            ok = ok & ~par.any(dim=0)
        bits, iters, done = _freeze(bits, iters, done, ok, signs, it)
        it += 1

    return MSResult(success=done, iterations=iters, bits=bits.t().to(torch.uint8).contiguous())


def make_sp_decoder(code: LDPCCode | str, maxiters: int = 100, device="cuda"):
    """Flooding sum-product decoder (impl "sp"), plain PyTorch, float32.

    Returns fn(llrs: (B, n) float32 true LLRs) -> MSResult, run on `device`.
    At maxiters = 0 the bits are the hard decisions of the LLRs, as in the
    JAX twin.
    """
    code = get_code(code)
    dev = resolve_device(device)
    n = code.n

    def decode(llrs) -> MSResult:
        llrs = torch.as_tensor(llrs, device=dev)
        check_sp_llrs(llrs, n)
        return flooding_sp_plain(code, llrs, maxiters)

    return decode


def make_sp_decoder_layered(code: LDPCCode | str, maxiters: int = 100, device="cuda"):
    """Row-layered sum-product decoder, plain PyTorch, float32: the twin of
    the layered BP kernel (`ops/cuda_sp.py`; impl "sp_layered" runs that
    kernel on a CUDA device and this function on the CPU).

    Returns fn(llrs: (B, n) float32 true LLRs) -> MSResult, run on `device`.
    At maxiters = 0 the bits are zero, as in the JAX twin.
    """
    code = get_code(code)
    dev = resolve_device(device)
    s = qc_structure(code)
    n = code.n

    def decode(llrs) -> MSResult:
        llrs = torch.as_tensor(llrs, device=dev)
        check_sp_llrs(llrs, n)
        return layered_sp_plain(s, llrs, maxiters)

    return decode
