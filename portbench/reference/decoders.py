"""Plain PyTorch decoders the benchmark judges the program by.

Frozen, self-contained versions of the row-layered self-corrected min-sum
(float32, and a saturating integer form whose bounds are a parameter, so
that the int8 configuration and its int4 control are one function) and of
the Gallager bit-flip decoder with the TM codes' erasure pass over the
punctured tail. They follow the upstream crate's decoder (decoder.rs:
decode_ms 347-475, decode_bf 243-301, decode_erasures 144-223) in the
layered order the program's kernels state; they run on whatever device
their inputs are on. Node-major state: each M-row block of nodes is an
(M, B) plane, and every block of H is a permutation, so message movement is
`torch.roll` (`perm_rows`).

Layered min-sum, per block row ("layer"), addend by addend:
  t = perm(va[col]) - u_old, saturated in the int form, set to 0 where its
  sign flipped against the previous t (self-correction); the two smallest
  |t| and the sign product over the layer; u = +-(m2 if |t| == m1 else m1);
  va[col] += perm_inv(u - u_old). The posterior is never clipped. After the
  last layer the syndrome of the posteriors' signs is taken; a codeword that
  satisfies every check keeps its bits and the 0-based iteration.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .codes import Addend, Code

__all__ = ["Result", "perm_rows", "layered_minsum", "bitflip"]


class Result(NamedTuple):
    success: torch.Tensor  # (B,) bool
    iterations: torch.Tensor  # (B,) int32: 0-based iteration of convergence, or maxiters
    bits: torch.Tensor  # (B, n + punctured) uint8


def perm_rows(x: torch.Tensor, a: Addend, inverse: bool = False) -> torch.Tensor:
    """out[i] = x[perm(i)] (check side of a variable block); inverse:
    out[perm(i)] = x[i]."""
    m = x.shape[0]
    if a.kind == "rot":
        return torch.roll(x, a.shift if inverse else -a.shift, dims=0)
    q = m // 4
    parts = []
    for t in range(4):
        if inverse:
            j = (t - a.theta) % 4
            parts.append(torch.roll(x[j * q:(j + 1) * q], a.phis[j], dims=0))
        else:
            s = (a.theta + t) % 4
            parts.append(torch.roll(x[s * q:(s + 1) * q], -a.phis[t], dims=0))
    return torch.cat(parts, dim=0)


def _blocks(c: Code, x: torch.Tensor, dtype: torch.dtype) -> list[torch.Tensor]:
    """(B, n) -> the (M, B) blocks of every variable column; punctured = 0."""
    xt = x.t().to(dtype).contiguous()
    zero = torch.zeros((c.m, x.shape[0]), dtype=dtype, device=x.device)
    n_tx = c.n // c.m
    return [xt[i * c.m:(i + 1) * c.m] for i in range(n_tx)] + [zero] * (c.n_block_cols - n_tx)


def layered_minsum(c: Code, llrs: torch.Tensor, maxiters: int,
                   bounds: tuple[int, int] | None = None) -> Result:
    """Decode (B, n) LLRs. `bounds=None`: float32 arithmetic. `bounds=(lo,
    hi)`: integer LLRs, computed in int32 with every message t clipped to
    [lo, hi] and |t| to hi (int8: (-128, 127))."""
    M, B, dev = c.m, llrs.shape[0], llrs.device
    is_int = bounds is not None
    cdt = torch.int32 if is_int else torch.float32
    big = bounds[1] if is_int else torch.finfo(torch.float32).max
    zero = torch.zeros((), dtype=cdt, device=dev)

    def sat(x):
        return x.clamp(*bounds) if is_int else x

    def mag(x):
        return torch.clamp(x.abs(), max=bounds[1]) if is_int else x.abs()

    va = _blocks(c, llrs, cdt)
    n_add = sum(len(r) for r in c.rows)
    us = [torch.zeros((M, B), dtype=cdt, device=dev) for _ in range(n_add)]
    tps = [torch.zeros((M, B), dtype=cdt, device=dev) for _ in range(n_add)]
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    iters = torch.full((B,), maxiters, dtype=torch.int32, device=dev)
    bits = torch.zeros((c.n_block_cols * M, B), dtype=torch.bool, device=dev)
    it = 0
    while it < maxiters and not bool(done.all()):
        e0 = 0
        for row in c.rows:
            ts = []
            for a_i, a in enumerate(row):
                t = sat(perm_rows(va[a.col], a) - us[e0 + a_i])
                tp = tps[e0 + a_i]
                ts.append(torch.where(((t < 0) == (tp < 0)) | (tp == 0), t, zero))
            m1 = torch.full((M, B), big, dtype=cdt, device=dev)
            m2 = m1
            sg = torch.zeros((M, B), dtype=torch.bool, device=dev)
            mags = []
            for t in ts:
                a1 = mag(t)
                mags.append(a1)
                m2 = torch.where(a1 < m1, m1, torch.minimum(m2, a1))
                m1 = torch.minimum(m1, a1)
                sg = sg ^ (t < 0)
            for a_i, a in enumerate(row):
                e = e0 + a_i
                u = torch.where(mags[a_i] == m1, m2, m1)
                u = torch.where(sg ^ (ts[a_i] < 0), -u, u)
                va[a.col] = va[a.col] + perm_rows(u - us[e], a, inverse=True)
                us[e] = u
                tps[e] = ts[a_i]
            e0 += len(row)
        signs = [v < 0 for v in va]
        ok = torch.ones((B,), dtype=torch.bool, device=dev)
        for row in c.rows:
            par = torch.zeros((M, B), dtype=torch.bool, device=dev)
            for a in row:
                par = par ^ perm_rows(signs[a.col], a)
            ok = ok & ~par.any(dim=0)
        bits = torch.where(done[None, :], bits, torch.cat(signs))
        iters = torch.where(ok & ~done, torch.full_like(iters, it), iters)
        done = done | ok
        it += 1
    return Result(done, iters, bits.t().to(torch.uint8).contiguous())


def bitflip(c: Code, hard: torch.Tensor, maxiters: int) -> Result:
    """Decode (B, n) 0/1 hard bits: one erasure vote over the punctured tail
    (when maxiters > 0), then per iteration every check's parity, every
    variable's count of violated checks, and a flip of all variables whose
    count equals the codeword's maximum, until no check is violated."""
    M, Cc = c.m, c.n_block_cols
    B, n = hard.shape
    dev = hard.device
    i32 = torch.int32
    full = torch.zeros((Cc * M, B), dtype=torch.uint8, device=dev)
    full[:n] = hard.t()
    blocks = list(full.split(M))

    def row_parity(row):
        par = torch.zeros_like(blocks[0])
        for a in row:
            par = par ^ perm_rows(blocks[a.col], a)
        return par

    if maxiters > 0 and c.punctured:
        node = torch.arange(M, device=dev)
        erased = [node + col * M >= n for col in range(Cc)]
        votes = [torch.zeros((M, B), dtype=i32, device=dev) for _ in range(Cc)]
        for row in c.rows:
            count = sum(perm_rows(erased[a.col].to(i32), a) for a in row)
            vote = torch.where(row_parity(row) == 1, 1, -1).to(i32) * (count == 1)[:, None]
            for a in row:
                votes[a.col] = votes[a.col] + perm_rows(vote, a, inverse=True)
        blocks = [torch.where(erased[col][:, None] & (votes[col] > 0), 1, blocks[col])
                  .to(torch.uint8) for col in range(Cc)]

    # a codeword that satisfies every check leaves the working set: codewords
    # never interact, so only the live ones are iterated
    out = torch.cat(blocks)
    iters = torch.full((B,), maxiters, dtype=i32, device=dev)
    live = torch.arange(B, device=dev)
    it = 0
    while it < maxiters and live.numel():
        viol = [torch.zeros((M, live.numel()), dtype=i32, device=dev) for _ in range(Cc)]
        for row in c.rows:
            par = row_parity(row).to(i32)
            for a in row:
                viol[a.col] = viol[a.col] + perm_rows(par, a, inverse=True)
        mx = torch.stack([v.amax(dim=0) for v in viol]).amax(dim=0)
        ok = mx == 0
        blocks = [torch.where((viol[col] == mx) & ~ok, blocks[col] ^ 1, blocks[col])
                  for col in range(Cc)]
        if bool(ok.any()):
            iters[live[ok]] = it
            out[:, live[ok]] = torch.cat(blocks)[:, ok]
            live, blocks = live[~ok], [b[:, ~ok] for b in blocks]
        it += 1
    out[:, live] = torch.cat(blocks)
    done = torch.ones((B,), dtype=torch.bool, device=dev)
    done[live] = False
    return Result(done, iters, out.t().contiguous())
