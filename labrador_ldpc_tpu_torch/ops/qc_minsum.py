"""Self-corrected min-sum over the QC block structure (plain PyTorch).

PyTorch counterpart of `labrador_ldpc_tpu/ops/qc_minsum.py`: `perm_rows`,
the row-layered schedule (`make_ms_decoder_layered`: float32, bfloat16,
float64 and the saturating int8/int16 form) and the reference's flooding
schedule (`make_ms_decoder_qc`, float32/bfloat16/float64;
`make_ms_decoder_qc_int`, saturating int8/int16). `layered_minsum_plain` and
`flooding_minsum_plain` are the plain versions of the CUDA kernels in
`ops/cuda_layered.py` and `ops/cuda_qc.py` (and their CPU path). The TPU
kernels are pinned bit-exact to the JAX twins in float32 and the int forms,
this module is pinned bit-exact to the JAX twins and to the interpreted TPU
kernels on the CPU (tests/test_torch_layered*.py, test_torch_flooding.py,
test_torch_int*.py, test_torch_bf16.py, test_torch_f64.py), and the CUDA
kernels are pinned bit-exact to this module on the card (chip_smoke.py).

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

bfloat16 follows the TPU kernels' storage contract (pallas_qc.py:38-41): the
state (posteriors, u, t', v, the two-min) is stored in bfloat16 and the
arithmetic runs in float32, with a rounding wherever a kernel stores a value.
Layered (pallas_qc.py:880-1006, pallas_tc.py:339-410): t = g - u_old stays
float32 (the self-correction and the sign product read it), the two-min
takes |bf16(t)|, u = +-mag is float32 (alpha * mag a float32 product), and
va <- bf16(va + bf16(u - u_old)). Flooding (pallas_qc.py:405-455,
pallas_tc.py:611, 658): va <- bf16(va + bf16(u)) addend by addend,
nv = g - u in float32 with the self-correction against the stored v, and the
two-min takes |bf16(nv)|. The XLA twins compute in bfloat16 instead (every
op rounds, and alpha itself is a bfloat16): without alpha the two agree
exactly, since every value that feeds a comparison or a store is the same
bfloat16 number; with alpha they differ by alpha's rounding. `round_alpha`
selects the twin's alpha (the twins' decoders below pass it); everything else
is one function. float64 computes plainly in float64.
"""

from __future__ import annotations

import torch

from ..codes.expand import BlockPerm, QCStructure, qc_structure
from ..codes.params import LDPCCode, get_code
from ..device import resolve_device
from .minsum import FLOAT_DTYPES, MSResult, check_dtype

__all__ = [
    "make_ms_decoder_layered",
    "make_ms_decoder_qc",
    "make_ms_decoder_qc_int",
    "make_ms_decoder_qc_i8",
    "layered_minsum_plain",
    "flooding_minsum_plain",
    "perm_rows",
]

SAT_DTYPES = (torch.int8, torch.int16)
# LLR dtypes of the QC decoders (plain PyTorch) and of their CUDA kernels,
# which take what the TPU kernels take: no float64
QC_DTYPES = (*FLOAT_DTYPES, *SAT_DTYPES)
KERNEL_DTYPES = (torch.float32, torch.bfloat16, *SAT_DTYPES)


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
            "the QC decoders take float and int8/int16 LLRs; int32 LLRs go to the "
            "reference-order decoder (impl='ref', make_ms_decoder)"
        )
    if llrs.dtype == torch.float64 and torch.float64 not in dtypes:
        raise ValueError(
            "the CUDA min-sum kernels take float32/bfloat16/int8/int16 LLRs, as the TPU "
            "kernels do; float64 LLRs go to impl='layered'|'qc'|'ref'"
        )
    check_dtype(llrs.dtype, dtypes)
    if alpha is not None and llrs.dtype in SAT_DTYPES:
        raise ValueError("the saturating int paths do not support alpha (float only)")
    if llrs.ndim != 2 or llrs.shape[1] != n:
        raise ValueError(f"llrs must be (B, {n}), got {tuple(llrs.shape)}")


class _Arith:
    """Compute dtype, two-min seed, saturation and storage rounding of one
    LLR dtype: float32 and float64 compute in their own dtype; bfloat16
    computes in float32 and rounds to bfloat16 where the kernels store;
    int8/int16 compute in int32 with explicit clips."""

    def __init__(self, dtype: torch.dtype, device: torch.device, alpha: float | None = None,
                 round_alpha: bool = False):
        self.is_int = dtype in SAT_DTYPES
        self.rounds = dtype == torch.bfloat16
        if self.is_int:
            info = torch.iinfo(dtype)
            self.lo, self.hi = info.min, info.max
            self.cdt = torch.int32
            self.big = self.hi  # the int two-min seeds at the saturation point
        else:
            self.cdt = torch.float32 if self.rounds else dtype
            self.big = torch.finfo(self.cdt).max
        self.zero = torch.zeros((), dtype=self.cdt, device=device)
        self.round_alpha = round_alpha and self.rounds
        self.alpha = None
        if alpha is not None:
            adt = torch.bfloat16 if self.round_alpha else self.cdt
            self.alpha = torch.tensor(alpha, dtype=adt, device=device).to(self.cdt)

    def sat(self, x: torch.Tensor) -> torch.Tensor:
        return x.clamp(self.lo, self.hi) if self.is_int else x

    def store(self, x: torch.Tensor) -> torch.Tensor:
        """x as the kernels store it: rounded to bfloat16 in the bf16 form."""
        return x.to(torch.bfloat16).to(self.cdt) if self.rounds else x

    def sat_abs(self, x: torch.Tensor) -> torch.Tensor:
        """|x| of a message as the two-min sees it: |-128| -> 127 (|-32768|
        -> 32767) in the int forms, |bf16(x)| in the bf16 form."""
        if self.is_int:
            return torch.clamp(x.abs(), max=self.hi)
        return self.store(x).abs()

    def post(self, va: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
        """The posterior update va + d: bf16(va + bf16(d)) in the bf16 form."""
        return self.store(va + self.store(d))

    def scale(self, mag: torch.Tensor) -> torch.Tensor:
        """alpha * mag: a float32 product in the kernels' bf16 form, the
        twin's bfloat16 product of a bfloat16 alpha with `round_alpha`."""
        out = self.alpha * mag
        return self.store(out) if self.round_alpha else out


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
    round_alpha: bool = False,
) -> MSResult:
    """Decode (B, n) LLRs of `QC_DTYPES` on their own device; `round_alpha`
    takes the XLA twin's bfloat16 alpha (module docstring)."""
    M, Cc = s.m, s.n_block_cols
    B = llrs.shape[0]
    dev = llrs.device
    ar = _Arith(llrs.dtype, dev, alpha, round_alpha)
    cdt, zero = ar.cdt, ar.zero

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
            # the int forms, decoder.rs:46-48, never rounded in the bf16 form),
            # with the reference's self-correction (zero on sign flip,
            # decoder.rs:420-426)
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
                if ar.alpha is not None:
                    mag = ar.scale(mag)
                u = torch.where(sg ^ (t < 0), -mag, mag)
                # va <- va + perm_inv(u_new - u_old), addend by addend
                va[perm.col] = ar.post(va[perm.col], perm_rows(u - us[e], perm, inverse=True))
                us[e] = ar.store(u)
                tps[e] = ar.store(t)

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
    round_alpha: bool = False,
) -> MSResult:
    """Flooding self-corrected min-sum of (B, n) LLRs of `QC_DTYPES` on their
    own device: `make_ms_decoder_qc` for the float dtypes,
    `make_ms_decoder_qc_int` (saturating at every add and sub) for ints;
    `round_alpha` takes the XLA twin's bfloat16 alpha (module docstring)."""
    M, R, Cc = s.m, s.n_block_rows, s.n_block_cols
    B = llrs.shape[0]
    dev = llrs.device
    ar = _Arith(llrs.dtype, dev, alpha, round_alpha)
    cdt, zero = ar.cdt, ar.zero
    llr_blocks = _llr_blocks(s, llrs, cdt)
    row_off = _row_offsets(s)

    def u_from(v, m1, m2, sg):
        """Check -> var message from the check's stats (decoder.rs:388-405);
        |v| is not saturated here (|-128| == 128 never equals a stored min)."""
        mag = torch.where(v.abs() == m1, m2, m1)
        if ar.alpha is not None:
            mag = ar.scale(mag)
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
        # saturating (int) or rounding (bf16) after every add
        va = list(llr_blocks)
        for r, row in enumerate(s.rows):
            for a, perm in enumerate(row):
                u = u_from(vs[row_off[r] + a], min1[r], min2[r], sgn[r])
                va[perm.col] = ar.sat(ar.post(va[perm.col], perm_rows(u, perm, inverse=True)))

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
                new_vs.append(ar.store(nv))
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
    """Row-layered self-corrected min-sum decoder, plain PyTorch: the twin of
    the JAX package's `make_ms_decoder_layered`.

    Returns fn(llrs: (B, n) float32, bfloat16, float64, int8 or int16) ->
    MSResult, run on `device`. Positive LLRs favor bit 0. `alpha` (normalized
    min-sum, float dtypes only; a bfloat16 alpha for bfloat16 LLRs, as the
    twin's) scales the check magnitudes; None keeps the plain self-corrected
    min-sum. The int forms saturate messages and keep the posterior wide.
    """
    code = get_code(code)
    dev = resolve_device(device)
    s = qc_structure(code)
    n = code.n

    def decode(llrs) -> MSResult:
        llrs = torch.as_tensor(llrs, device=dev)
        check_llrs(llrs, n, alpha)
        return layered_minsum_plain(s, llrs, maxiters, alpha, self_corrected, round_alpha=True)

    return decode


def make_ms_decoder_qc(
    code: LDPCCode | str,
    maxiters: int = 20,
    alpha: float | None = None,
    device="cuda",
):
    """Flooding self-corrected min-sum decoder (the reference's schedule),
    plain PyTorch, float32/bfloat16/float64: the twin of the JAX package's
    `make_ms_decoder_qc`.

    Returns fn(llrs: (B, n) float) -> MSResult, run on `device`; int8 and
    int16 LLRs go to `make_ms_decoder_qc_int`. With bfloat16 LLRs alpha is a
    bfloat16, as the twin's.
    """
    code = get_code(code)
    dev = resolve_device(device)
    s = qc_structure(code)
    n = code.n

    def decode(llrs) -> MSResult:
        llrs = torch.as_tensor(llrs, device=dev)
        if llrs.dtype in SAT_DTYPES:
            raise ValueError("make_ms_decoder_qc takes float LLRs; int8/int16 go to "
                             "make_ms_decoder_qc_int")
        check_llrs(llrs, n, alpha, FLOAT_DTYPES)
        return flooding_minsum_plain(s, llrs, maxiters, alpha, round_alpha=True)

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
