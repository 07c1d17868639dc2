"""Self-corrected min-sum over the QC block structure (plain PyTorch).

PyTorch counterpart of `labrador_ldpc_tpu/ops/qc_minsum.py`: `perm_rows`,
the row-layered schedule (`make_ms_decoder_layered`, float32 and the
saturating int8/int16 form) and the reference's flooding schedule
(`make_ms_decoder_qc`, float32; `make_ms_decoder_qc_int`, saturating
int8/int16). `layered_minsum_plain` and `flooding_minsum_plain` are the plain
versions of the CUDA kernels in `ops/cuda_layered.py` and `ops/cuda_qc.py`
(and their CPU path). The TPU kernels are pinned bit-exact to the JAX twins,
this module is pinned bit-exact to the JAX twins on the CPU
(tests/test_torch_layered*.py, test_torch_flooding.py, test_torch_int*.py),
and the CUDA kernels are pinned bit-exact to this module on the card
(chip_smoke.py).

Every nonzero M x M sub-block of H is a permutation (codes/expand.py
`qc_structure`), so all message movement is a `torch.roll` along the node
axis. State is node-major: each block is an (M, B) plane.

Layered schedule (qc_minsum.py:223-404 of the JAX package): the block-rows
of H are processed in order inside one iteration; each layer reads the
posteriors `va` already updated by the layers before it. Per layer:
  1. t = perm(va[col]) - u_old for every addend, with the self-correction
     t = 0 where the sign flipped against the previous t' (t' != 0);
  2. two smallest |t| and the sign product across the layer's addends;
  3. u = +-(m2 if |t| == m1 else m1) (times alpha if set), and
     va[col] = va[col] + perm_inv(u - u_old), addend by addend.
After the last layer the syndrome is taken over the final posteriors, and a
codeword that satisfies every check freezes its bits and iteration. The int
forms clip t to the dtype (messages saturate) but keep the posterior wide:
it is never clipped (qc_minsum.py:245-262).

Flooding schedule (qc_minsum.py:75-220, 407-549; decoder.rs:347-475): each
iteration recomputes the posteriors from the channel LLRs (sweep 1: every
addend's u, from the check's stored two-min and sign, added in row then
addend order), then (sweep 2) every check takes its self-corrected v = g - u
over the gathered posteriors g, its new two-min and sign, and the parity of
g. The int form saturates after every add and sub, as DecodeFrom does.
"""

from __future__ import annotations

import torch

from ..codes.expand import BlockPerm, QCStructure, qc_structure
from ..codes.params import LDPCCode, get_code
from ..device import resolve_device
from .minsum import MSResult, check_dtype

__all__ = [
    "make_ms_decoder_layered",
    "make_ms_decoder_qc",
    "make_ms_decoder_qc_int",
    "make_ms_decoder_qc_i8",
    "layered_minsum_plain",
    "flooding_minsum_plain",
    "perm_rows",
]

# LLR dtypes of the QC decoders and their kernels
QC_DTYPES = (torch.float32, torch.int8, torch.int16)
SAT_DTYPES = (torch.int8, torch.int16)


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


def check_llrs(llrs: torch.Tensor, n: int, alpha: float | None,
               dtypes: tuple = QC_DTYPES) -> None:
    """Raise a ValueError unless llrs is (B, n) of one of `dtypes`, and alpha
    is None for the saturating int dtypes."""
    if llrs.dtype == torch.int32 and torch.int32 not in dtypes:
        raise ValueError(
            "the QC decoders take float32/int8/int16 LLRs; int32 LLRs go to the "
            "reference-order decoder (impl='ref', make_ms_decoder)"
        )
    check_dtype(llrs.dtype, dtypes)
    if alpha is not None and llrs.dtype in SAT_DTYPES:
        raise ValueError("the saturating int paths do not support alpha (float32 only)")
    if llrs.ndim != 2 or llrs.shape[1] != n:
        raise ValueError(f"llrs must be (B, {n}), got {tuple(llrs.shape)}")


class _Arith:
    """Compute dtype, two-min seed and saturation of one LLR dtype: float32
    computes in float32; int8/int16 compute in int32 with explicit clips."""

    def __init__(self, dtype: torch.dtype, device: torch.device):
        self.is_int = dtype in SAT_DTYPES
        if self.is_int:
            info = torch.iinfo(dtype)
            self.lo, self.hi = info.min, info.max
            self.cdt = torch.int32
            self.big = self.hi  # the int two-min seeds at the saturation point
        else:
            self.cdt = torch.float32
            self.big = torch.finfo(torch.float32).max
        self.zero = torch.zeros((), dtype=self.cdt, device=device)

    def sat(self, x: torch.Tensor) -> torch.Tensor:
        return x.clamp(self.lo, self.hi) if self.is_int else x

    def sat_abs(self, x: torch.Tensor) -> torch.Tensor:
        """|x|, with |-128| -> 127 (|-32768| -> 32767) in the int forms."""
        return torch.clamp(x.abs(), max=self.hi) if self.is_int else x.abs()


def _row_offsets(s: QCStructure) -> list[int]:
    row_off = [0]
    for row in s.rows:
        row_off.append(row_off[-1] + len(row))
    return row_off


def _llr_blocks(s: QCStructure, llrs: torch.Tensor, cdt: torch.dtype) -> list[torch.Tensor]:
    """The (M, B) node-major blocks of the LLRs in `cdt`; punctured tail = 0
    (decoder.rs:382-383)."""
    M = s.m
    n_blocks = llrs.shape[1] // M  # transmitted blocks; the rest are punctured
    llr_t = llrs.t().to(cdt).contiguous()
    zeros = torch.zeros((M, llrs.shape[0]), dtype=cdt, device=llrs.device)
    return [llr_t[c * M : (c + 1) * M] for c in range(n_blocks)] + [
        zeros for _ in range(s.n_block_cols - n_blocks)
    ]


def layered_minsum_plain(
    s: QCStructure,
    llrs: torch.Tensor,
    maxiters: int,
    alpha: float | None = None,
    self_corrected: bool = True,
) -> MSResult:
    """Decode (B, n) float32, int8 or int16 LLRs on their own device."""
    M, Cc = s.m, s.n_block_cols
    B = llrs.shape[0]
    dev = llrs.device
    ar = _Arith(llrs.dtype, dev)
    cdt, zero = ar.cdt, ar.zero
    alpha_t = None if alpha is None else torch.tensor(alpha, dtype=cdt, device=dev)

    va = _llr_blocks(s, llrs, cdt)  # wide posteriors: never clipped in the int forms
    row_off = _row_offsets(s)
    sumA = row_off[-1]
    us = [torch.zeros((M, B), dtype=cdt, device=dev) for _ in range(sumA)]
    tps = [torch.zeros((M, B), dtype=cdt, device=dev) for _ in range(sumA)]
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    iters = torch.full((B,), maxiters, dtype=torch.int32, device=dev)
    bits = torch.zeros((Cc * M, B), dtype=torch.bool, device=dev)

    it = 0
    while it < maxiters and not bool(done.all()):
        for r, row in enumerate(s.rows):
            # extrinsic t = va - u for each addend of this layer (saturated in
            # the int forms, decoder.rs:46-48), with the reference's
            # self-correction (zero on sign flip, decoder.rs:420-426)
            ts = []
            for a, perm in enumerate(row):
                e = row_off[r] + a
                t = ar.sat(perm_rows(va[perm.col], perm) - us[e])
                if self_corrected:
                    tp = tps[e]
                    keep = ((t < 0) == (tp < 0)) | (tp == 0)
                    t = torch.where(keep, t, zero)
                ts.append(t)
            # two smallest |t| + sign product across the layer's addends
            m1 = torch.full((M, B), ar.big, dtype=cdt, device=dev)
            m2 = m1
            sg = torch.zeros((M, B), dtype=torch.bool, device=dev)
            a1s = []
            for t in ts:
                a1 = ar.sat_abs(t)
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
        bits, iters, done = _freeze(bits, iters, done, ok, signs, it)
        it += 1

    return MSResult(success=done, iterations=iters, bits=bits.t().to(torch.uint8).contiguous())


def _freeze(bits, iters, done, ok, signs, it):
    """Keep the bits and iteration of codewords already done; take this
    iteration's for the rest, and mark the ones that converged now."""
    newly_done = ok & ~done
    bits = torch.where(done[None, :], bits, torch.cat(signs, dim=0))
    iters = torch.where(newly_done, torch.full_like(iters, it), iters)
    return bits, iters, done | ok


def flooding_minsum_plain(
    s: QCStructure,
    llrs: torch.Tensor,
    maxiters: int,
    alpha: float | None = None,
) -> MSResult:
    """Flooding self-corrected min-sum of (B, n) float32, int8 or int16 LLRs
    on their own device: `make_ms_decoder_qc` for float32,
    `make_ms_decoder_qc_int` (saturating at every add and sub) for ints."""
    M, R, Cc = s.m, s.n_block_rows, s.n_block_cols
    B = llrs.shape[0]
    dev = llrs.device
    ar = _Arith(llrs.dtype, dev)
    cdt, zero = ar.cdt, ar.zero
    alpha_t = None if alpha is None else torch.tensor(alpha, dtype=cdt, device=dev)
    llr_blocks = _llr_blocks(s, llrs, cdt)
    row_off = _row_offsets(s)

    def u_from(v, m1, m2, sg):
        """Check -> var message from the check's stats (decoder.rs:388-405);
        |v| is not saturated here (|-128| == 128 never equals a stored min)."""
        mag = torch.where(v.abs() == m1, m2, m1)
        if alpha_t is not None:
            mag = alpha_t * mag
        return torch.where(sg ^ (v < 0), -mag, mag)

    z = torch.zeros((M, B), dtype=cdt, device=dev)
    vs = [z] * row_off[-1]  # per-addend self-corrected var -> check messages
    min1, min2 = [z] * R, [z] * R  # decoder.rs:374: the working area starts at 0
    sgn = [torch.zeros((M, B), dtype=torch.bool, device=dev)] * R
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    iters = torch.full((B,), maxiters, dtype=torch.int32, device=dev)
    bits = torch.zeros((Cc * M, B), dtype=torch.bool, device=dev)

    it = 0
    while it < maxiters and not bool(done.all()):
        # sweep 1: marginals from the channel LLRs, in row then addend order,
        # saturating after every add in the int form
        va = list(llr_blocks)
        for r, row in enumerate(s.rows):
            for a, perm in enumerate(row):
                u = u_from(vs[row_off[r] + a], min1[r], min2[r], sgn[r])
                va[perm.col] = ar.sat(va[perm.col] + perm_rows(u, perm, inverse=True))

        # sweep 2: self-corrected v; the checks' new stats; parity of g
        new_vs = []
        ok = torch.ones((B,), dtype=torch.bool, device=dev)
        for r, row in enumerate(s.rows):
            m1 = torch.full((M, B), ar.big, dtype=cdt, device=dev)
            m2 = m1
            sg = torch.zeros((M, B), dtype=torch.bool, device=dev)
            par = torch.zeros((M, B), dtype=torch.bool, device=dev)
            for a, perm in enumerate(row):
                v_old = vs[row_off[r] + a]
                u = u_from(v_old, min1[r], min2[r], sgn[r])
                g = perm_rows(va[perm.col], perm)
                nv = ar.sat(g - u)
                keep = ((nv < 0) == (v_old < 0)) | (v_old == 0)
                nv = torch.where(keep, nv, zero)
                par = par ^ (g < 0)
                a1 = ar.sat_abs(nv)
                m2 = torch.where(a1 < m1, m1, torch.minimum(m2, a1))
                m1 = torch.minimum(m1, a1)
                sg = sg ^ (nv < 0)
                new_vs.append(nv)
            ok = ok & ~par.any(dim=0)
            min1[r], min2[r], sgn[r] = m1, m2, sg
        vs = new_vs

        # the bits are the signs of this iteration's sweep-1 posteriors
        bits, iters, done = _freeze(bits, iters, done, ok, [va[c] < 0 for c in range(Cc)], it)
        it += 1

    return MSResult(success=done, iterations=iters, bits=bits.t().to(torch.uint8).contiguous())


def make_ms_decoder_layered(
    code: LDPCCode | str,
    maxiters: int = 20,
    alpha: float | None = None,
    self_corrected: bool = True,
    device="cuda",
):
    """Row-layered self-corrected min-sum decoder, plain PyTorch.

    Returns fn(llrs: (B, n) float32, int8 or int16) -> MSResult, run on
    `device`. Positive LLRs favor bit 0. `alpha` (normalized min-sum, float32
    only) scales the check magnitudes; None keeps the plain self-corrected
    min-sum. The int forms saturate messages and keep the posterior wide.
    """
    code = get_code(code)
    dev = resolve_device(device)
    s = qc_structure(code)
    n = code.n

    def decode(llrs) -> MSResult:
        llrs = torch.as_tensor(llrs, device=dev)
        check_llrs(llrs, n, alpha)
        return layered_minsum_plain(s, llrs, maxiters, alpha, self_corrected)

    return decode


def make_ms_decoder_qc(
    code: LDPCCode | str,
    maxiters: int = 20,
    alpha: float | None = None,
    device="cuda",
):
    """Flooding self-corrected min-sum decoder (the reference's schedule),
    plain PyTorch, float32.

    Returns fn(llrs: (B, n) float32) -> MSResult, run on `device`; int8 and
    int16 LLRs go to `make_ms_decoder_qc_int`.
    """
    code = get_code(code)
    dev = resolve_device(device)
    s = qc_structure(code)
    n = code.n

    def decode(llrs) -> MSResult:
        llrs = torch.as_tensor(llrs, device=dev)
        if llrs.dtype in SAT_DTYPES:
            raise ValueError("make_ms_decoder_qc takes float32 LLRs; int8/int16 go to "
                             "make_ms_decoder_qc_int")
        check_llrs(llrs, n, alpha, (torch.float32,))
        return flooding_minsum_plain(s, llrs, maxiters, alpha)

    return decode


def make_ms_decoder_qc_int(
    code: LDPCCode | str,
    dtype: torch.dtype = torch.int8,
    maxiters: int = 20,
    device="cuda",
):
    """Flooding self-corrected min-sum with saturating int8/int16 messages,
    plain PyTorch: every add and sub clamps to the dtype range and |x| is
    clamped to its max, as the reference's DecodeFrom (decoder.rs:42-55).

    Returns fn(llrs: (B, n) `dtype`) -> MSResult, run on `device`.
    """
    if dtype not in SAT_DTYPES:
        raise ValueError(f"the QC int decoder takes int8/int16, got {dtype}")
    code = get_code(code)
    dev = resolve_device(device)
    s = qc_structure(code)
    n = code.n

    def decode(llrs) -> MSResult:
        llrs = torch.as_tensor(llrs, device=dev)
        if llrs.dtype != dtype:
            raise ValueError(f"this decoder was built for {dtype} LLRs, got {llrs.dtype}")
        check_llrs(llrs, n, None, SAT_DTYPES)
        return flooding_minsum_plain(s, llrs, maxiters)

    return decode


def make_ms_decoder_qc_i8(code: LDPCCode | str, maxiters: int = 20, device="cuda"):
    """`make_ms_decoder_qc_int(code, torch.int8, maxiters)`."""
    return make_ms_decoder_qc_int(code, torch.int8, maxiters, device)
