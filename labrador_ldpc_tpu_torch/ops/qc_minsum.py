"""Row-layered self-corrected min-sum over the QC block structure (plain PyTorch).

PyTorch counterpart of `labrador_ldpc_tpu/ops/qc_minsum.py`: `perm_rows`
and `make_ms_decoder_layered`, float32. This is the plain version of the CUDA
kernel in `ops/cuda_layered.py` (and the CPU path): both TPU kernels of the
main path (pallas_qc.make_ms_decoder_pallas_layered and
pallas_tc.make_ms_decoder_pallas_tc_layered) are pinned bit-exact to the JAX
twin, this module is pinned bit-exact to the JAX twin on the CPU
(tests/test_torch_layered.py), and the CUDA kernel is pinned bit-exact to
this module on the card (chip_smoke.py).

Every nonzero M x M sub-block of H is a permutation (codes/expand.py
`qc_structure`), so all message movement is a `torch.roll` along the node
axis. State is node-major: each block is an (M, B) plane.

The schedule (qc_minsum.py:223-404 of the JAX package) processes the
block-rows of H in order inside one iteration; each layer reads the
posteriors `va` already updated by the layers before it. Per layer:
  1. t = perm(va[col]) - u_old for every addend, with the self-correction
     t = 0 where the sign flipped against the previous t' (t' != 0);
  2. two smallest |t| and the sign product across the layer's addends;
  3. u = +-(m2 if |t| == m1 else m1) (times alpha if set), and
     va[col] = va[col] + perm_inv(u - u_old), addend by addend.
After the last layer the syndrome is taken over the final posteriors, and a
codeword that satisfies every check freezes its bits and iteration.
"""

from __future__ import annotations

import torch

from ..codes.expand import BlockPerm, QCStructure, qc_structure
from ..codes.params import LDPCCode, get_code
from ..device import resolve_device
from .minsum import MSResult

__all__ = ["make_ms_decoder_layered", "layered_minsum_plain", "perm_rows"]


def perm_rows(x: torch.Tensor, perm: BlockPerm, inverse: bool = False) -> torch.Tensor:
    """Apply an M x M block permutation to the leading axis of x: (M, ...).

    Forward:  out[i] = x[perm(i)]   (check-side view of a var block)
    Inverse:  out[perm(i)] = x[i]   (scatter check-side values to var side)
    """
    m = x.shape[0]
    if perm.kind == "rot":
        # out[i] = x[(i + s) % M]  <=>  roll by -s
        return torch.roll(x, perm.shift if inverse else -perm.shift, dims=0)
    q = m // 4
    parts = []
    for t in range(4):  # output quarter
        if inverse:
            j = (t - perm.theta) % 4  # source quarter within check-side x
            parts.append(torch.roll(x[j * q : (j + 1) * q], perm.phis[j], dims=0))
        else:
            s = (perm.theta + t) % 4  # source var-side quarter
            parts.append(torch.roll(x[s * q : (s + 1) * q], -perm.phis[t], dims=0))
    return torch.cat(parts, dim=0)


def _check_f32_llrs(llrs: torch.Tensor, n: int) -> None:
    if llrs.dtype != torch.float32:
        raise ValueError(
            f"the layered decoder takes float32 LLRs in this port, got {llrs.dtype}; "
            "bfloat16/int8/int16 come with the main-path dtype slice (ROADMAP Queue A5)"
        )
    if llrs.ndim != 2 or llrs.shape[1] != n:
        raise ValueError(f"llrs must be (B, {n}), got {tuple(llrs.shape)}")


def layered_minsum_plain(
    s: QCStructure,
    llrs: torch.Tensor,
    maxiters: int,
    alpha: float | None = None,
    self_corrected: bool = True,
) -> MSResult:
    """Decode (B, n) float32 LLRs on their own device; returns MSResult."""
    M, R, Cc = s.m, s.n_block_rows, s.n_block_cols
    n = llrs.shape[1]
    n_blocks = n // M  # transmitted blocks; the rest are punctured
    B = llrs.shape[0]
    dev = llrs.device
    f32 = torch.float32
    zero = torch.zeros((), dtype=f32, device=dev)
    alpha_t = None if alpha is None else torch.tensor(alpha, dtype=f32, device=dev)
    big = torch.finfo(f32).max

    llr_t = llrs.t().contiguous()  # (n, B) node-major
    # punctured tail = 0 (decoder.rs:382-383)
    va = [llr_t[c * M : (c + 1) * M] for c in range(n_blocks)] + [
        torch.zeros((M, B), dtype=f32, device=dev) for _ in range(Cc - n_blocks)
    ]
    row_off = [0]
    for row in s.rows:
        row_off.append(row_off[-1] + len(row))
    sumA = row_off[-1]
    us = [torch.zeros((M, B), dtype=f32, device=dev) for _ in range(sumA)]
    tps = [torch.zeros((M, B), dtype=f32, device=dev) for _ in range(sumA)]
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    iters = torch.full((B,), maxiters, dtype=torch.int32, device=dev)
    bits = torch.zeros((Cc * M, B), dtype=torch.bool, device=dev)

    it = 0
    while it < maxiters and not bool(done.all()):
        for r, row in enumerate(s.rows):
            # extrinsic t = va - u for each addend of this layer, with the
            # reference's self-correction (zero on sign flip, decoder.rs:420-426)
            ts = []
            for a, perm in enumerate(row):
                e = row_off[r] + a
                t = perm_rows(va[perm.col], perm) - us[e]
                if self_corrected:
                    tp = tps[e]
                    keep = ((t < 0) == (tp < 0)) | (tp == 0)
                    t = torch.where(keep, t, zero)
                ts.append(t)
            # two smallest |t| + sign product across the layer's addends
            m1 = torch.full((M, B), big, dtype=f32, device=dev)
            m2 = m1
            sg = torch.zeros((M, B), dtype=torch.bool, device=dev)
            a1s = []
            for t in ts:
                a1 = t.abs()
                a1s.append(a1)
                m2 = torch.where(a1 < m1, m1, torch.minimum(m2, a1))
                m1 = torch.minimum(m1, a1)
                sg = sg ^ (t < 0)
            for a, perm in enumerate(row):
                e = row_off[r] + a
                t = ts[a]
                mag = torch.where(a1s[a] == m1, m2, m1)  # equality tie rule
                if alpha_t is not None:
                    mag = alpha_t * mag
                u = torch.where(sg ^ (t < 0), -mag, mag)
                # va <- va + perm_inv(u_new - u_old), addend by addend
                va[perm.col] = va[perm.col] + perm_rows(u - us[e], perm, inverse=True)
                us[e] = u
                tps[e] = t

        # end-of-iteration syndrome over the FINAL posteriors
        signs = [va[c] < 0 for c in range(Cc)]
        ok = torch.ones((B,), dtype=torch.bool, device=dev)
        for row in s.rows:
            par = torch.zeros((M, B), dtype=torch.bool, device=dev)
            for perm in row:
                par = par ^ perm_rows(signs[perm.col], perm)
            ok = ok & ~par.any(dim=0)
        # freeze hard decisions and iteration at each codeword's convergence
        newly_done = ok & ~done
        bits = torch.where(done[None, :], bits, torch.cat(signs, dim=0))
        iters = torch.where(newly_done, torch.full_like(iters, it), iters)
        done = done | ok
        it += 1

    return MSResult(success=done, iterations=iters, bits=bits.t().to(torch.uint8).contiguous())


def make_ms_decoder_layered(
    code: LDPCCode | str,
    maxiters: int = 20,
    alpha: float | None = None,
    self_corrected: bool = True,
    device="cuda",
):
    """Row-layered self-corrected min-sum decoder, plain PyTorch, float32.

    Returns fn(llrs: (B, n) float32) -> MSResult, run on `device`. Positive
    LLRs favor bit 0. `alpha` (normalized min-sum) scales the check
    magnitudes; None keeps the plain self-corrected min-sum.
    """
    code = get_code(code)
    dev = resolve_device(device)
    s = qc_structure(code)
    n = code.n

    def decode(llrs) -> MSResult:
        llrs = torch.as_tensor(llrs, device=dev)
        _check_f32_llrs(llrs, n)
        return layered_minsum_plain(s, llrs, maxiters, alpha, self_corrected)

    return decode
