"""Plain PyTorch belief propagation the benchmark judges the program's
sum-product path by: the true-LLR channel and the row-layered sum-product
decoder, frozen and self-contained (the reference's own `Code` tables and
`perm_rows`; nothing of the program).

`true_llrs(soft, sigma)`: the AWGN channel's true LLRs 2y/sigma^2 in
float32. sigma is rounded to a float32 tensor on the device of `soft`; then
s * s, then 2 (a float32 tensor on the same device) divided by it, then the
product with y: the program's order. A multiplication by a reciprocal
rounds otherwise.

`layered_sp(c, llrs, maxiters)`: row-layered BP of (B, n) float32 true LLRs,
node-major as `decoders.layered_minsum` (each M-row block an (M, B) plane,
punctured blocks 0, u of every addend 0 at the start). Per block row
("layer"), addend by addend:

  pass 1: t = perm(va[col]) - u_old, ph = phi(|t|); the layer's phi sum,
    accumulated from the first addend in addend order, and its sign product
    (t < 0: -0.0 counts as positive), accumulated the same way;
  pass 2: u = +-phi(phi_sum - ph), the sign being the product without this
    addend's sign, and va[col] = va[col] + perm_inv(u - u_old), addend by
    addend (two addends of a row on one column update it in turn).

After the last layer the syndrome of the posteriors' signs is taken; a
codeword that satisfies every check keeps those bits and the 0-based
iteration, and one that never does reports maxiters and its last signs. The
loop ends when every codeword is done or at maxiters; at maxiters 0 the bits
are 0.

Departures from textbook BP, each as the program states its decoder:
  * phi(x) = -ln tanh(x/2) is computed as log((1 + e^-x) / (1 - e^-x)), in
    float32 with `torch.exp` and `torch.log` (on the card the CUDA math
    library's expf and logf, the functions the program's kernel calls), an
    IEEE division between them; not through tanh, log1p or expm1, which
    round otherwise.
  * x is clamped to [PHI_EPS, PHI_CLIP] = [1e-6, 25] before phi: phi(0) is
    infinite, and at 25 e^-x is far below float32's step at 1, so phi there
    is 0 and the upper clamp changes no result.

Memory: all 15 u planes of TM8192 at B = 8,192 are 15 x 2048 x 8192 float32,
about 1 GB, beside the posteriors; a waterfall batch fits on the card whole,
so no blocking is needed.
"""

from __future__ import annotations

import torch

from .codes import Code
from .decoders import Result, perm_rows

__all__ = ["PHI_EPS", "PHI_CLIP", "phi", "true_llrs", "layered_sp"]

PHI_EPS = 1e-6
PHI_CLIP = 25.0


def phi(x: torch.Tensor) -> torch.Tensor:
    """-ln tanh(x/2) of x clamped into [PHI_EPS, PHI_CLIP]; its own inverse."""
    x = torch.clamp(x, PHI_EPS, PHI_CLIP)
    em = torch.exp(-x)
    return torch.log((1.0 + em) / (1.0 - em))


def true_llrs(soft: torch.Tensor, sigma: float) -> torch.Tensor:
    """2y/sigma^2 of the channel's float32 output y = `soft`."""
    s = torch.tensor(sigma, dtype=torch.float32, device=soft.device)
    two = torch.tensor(2.0, dtype=torch.float32, device=soft.device)
    return soft * torch.div(two, s * s)


def layered_sp(c: Code, llrs: torch.Tensor, maxiters: int) -> Result:
    """Decode (B, n) float32 true LLRs on their own device."""
    M, B, dev = c.m, llrs.shape[0], llrs.device
    f32 = torch.float32
    xt = llrs.t().to(f32).contiguous()
    n_tx = c.n // M
    zero = torch.zeros((M, B), dtype=f32, device=dev)
    va = [xt[i * M:(i + 1) * M] for i in range(n_tx)] + [zero] * (c.n_block_cols - n_tx)
    n_add = sum(len(r) for r in c.rows)
    us = [torch.zeros((M, B), dtype=f32, device=dev) for _ in range(n_add)]
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    iters = torch.full((B,), maxiters, dtype=torch.int32, device=dev)
    bits = torch.zeros((c.n_block_cols * M, B), dtype=torch.bool, device=dev)
    it = 0
    while it < maxiters and not bool(done.all()):
        e0 = 0
        for row in c.rows:
            # pass 1: every read of the layer's posteriors precedes any write
            ts = [perm_rows(va[a.col], a) - us[e0 + j] for j, a in enumerate(row)]
            phs = [phi(t.abs()) for t in ts]
            phi_sum = phs[0]
            for ph in phs[1:]:
                phi_sum = phi_sum + ph
            sg = ts[0] < 0.0
            for t in ts[1:]:
                sg = sg ^ (t < 0.0)
            # pass 2
            for j, a in enumerate(row):
                e = e0 + j
                mag = phi(phi_sum - phs[j])
                u = torch.where(sg ^ (ts[j] < 0.0), -mag, mag)
                va[a.col] = va[a.col] + perm_rows(u - us[e], a, inverse=True)
                us[e] = u
            e0 += len(row)
        signs = [v < 0.0 for v in va]
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
