"""Per-code memory tables of the CUDA decoders, and the reference's RAM table.

PyTorch counterpart of `labrador_ldpc_tpu/sizes.py`, itself the analogue of
the reference crate's per-code RAM tables (src/lib.rs:146-200). A caller of
the port sizes a batch, not a buffer, so a row says, per code, kernel and
LLR dtype:

  * the launch shape (`ops/routing.route_for`, the kernels' `launch_config`):
    threads a CTA, codewords a CTA, dynamic shared bytes a CTA and a
    codeword;
  * the CTAs that fit on one SM at a register count (`ops/card.ctas_per_sm`
    at the kernels' budget of 64 a thread by default; ptxas's count gives
    the card's, which `chip_smoke.py` holds to the occupancy calculator),
    and the codewords resident on one H100 (CTAs an SM x 132 SMs x
    codewords a CTA);
  * the device bytes a codeword moves in one decode: its LLRs (or hard
    bits) in, its bits, success flag and iteration count out. No kernel has
    a device scratch, so this does not depend on the iteration count;
  * the device bytes one decode of `batch` codewords allocates: input,
    output, the kernel's tables (as its wrapper builds them) and the
    bit-flip kernel's one int32 codeword counter.

The JAX module's scratch-spec functions (`*_scratch_specs`, sizes.py:56-132)
describe the Pallas kernels' VMEM scratch and have no counterpart: every
CUDA kernel keeps its decoder state in shared memory, sized by its
`launch_config`.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .codes.params import ALL_CODES, LDPCCode, get_code
from .ops import card, cuda_bf, cuda_layered, cuda_qc, cuda_sp
from .ops.routing import route_for

__all__ = [
    "DecoderMemory",
    "decoder_memory",
    "memory_table",
    "format_memory_table",
    "format_reference_table",
    "IMPLS",
]

IMPLS = ("cuda_layered", "cuda_qc", "cuda_sp", "cuda_bf")
_LLR_BYTES = {torch.float32: 4, torch.bfloat16: 2, torch.int8: 1, torch.int16: 2}
_OUT_BYTES = 1 + 4  # a codeword's success flag (bool) and iteration count (int32)


@dataclass(frozen=True)
class DecoderMemory:
    """Launch shape and device memory of one (code, impl, dtype) decoder."""

    code: str
    impl: str
    dtype: str  # the LLRs' dtype; "u8-bits" for the bit-flip kernel's hard bits
    threads: int  # a CTA
    codewords_per_cta: int
    smem_bytes_per_cta: int
    smem_bytes_per_cw: int  # the codeword's own state; the bit-flip CTA adds its table
    registers: int  # a thread, at which ctas_per_sm is counted
    ctas_per_sm: int
    resident_codewords: int  # on one H100
    bytes_per_cw: int  # device bytes one codeword moves in a decode
    batch: int
    alloc_bytes: int  # device bytes one decode of `batch` allocates


def _table_bytes(code: LDPCCode, impl: str) -> int:
    """Bytes of the kernel's device tables, as its wrapper builds them."""
    if impl == "cuda_bf":
        return cuda_bf.kernel_table(code)[0].nbytes
    mod = {"cuda_layered": cuda_layered, "cuda_qc": cuda_qc, "cuda_sp": cuda_sp}[impl]
    return sum(a.nbytes for a in mod.kernel_tables(code))


def decoder_memory(
    code: LDPCCode | str,
    impl: str = "cuda_layered",
    dtype: torch.dtype = torch.float32,
    batch: int = 16384,
    registers: int = card.REGISTERS_PER_THREAD,
) -> DecoderMemory:
    """Launch shape and device memory of one CUDA decoder configuration.

    impl: "cuda_layered" and "cuda_qc" (float32, bfloat16, int8, int16),
    "cuda_sp" (float32) or "cuda_bf" (hard bits; `dtype` is not read).
    """
    code = get_code(code)
    route = route_for(code)
    if impl in ("cuda_layered", "cuda_qc"):
        if dtype not in cuda_layered.FORMS:
            raise ValueError(f"impl {impl!r} takes {list(cuda_layered.FORMS)}, got {dtype}")
        forms = route.layered if impl == "cuda_layered" else route.flooding
        launch = getattr(forms, cuda_layered.FORMS[dtype])
        in_bytes, cw_per_cta, own = _LLR_BYTES[dtype], 1, launch.smem_bytes
        dtype_name = str(dtype).removeprefix("torch.")
    elif impl == "cuda_sp":
        if dtype != torch.float32:
            raise ValueError(f"impl 'cuda_sp' takes float32 LLRs, got {dtype}")
        launch = route.sumproduct
        in_bytes, cw_per_cta, own, dtype_name = 4, 1, launch.smem_bytes, "float32"
    elif impl == "cuda_bf":
        launch = route.bitflip
        in_bytes, cw_per_cta, dtype_name = 1, launch.codewords_per_cta, "u8-bits"
        own = (launch.smem_bytes - _table_bytes(code, impl)) // cw_per_cta
    else:
        raise ValueError(f"unknown impl {impl!r} ({'|'.join(IMPLS)})")
    ctas = card.ctas_per_sm(launch.smem_bytes, launch.threads, registers)
    counter = 4 if impl == "cuda_bf" else 0  # the bit-flip kernel's int32 codeword counter
    p = code.params
    per_cw = p.n * in_bytes + p.n_vars + _OUT_BYTES
    return DecoderMemory(
        code=code.value,
        impl=impl,
        dtype=dtype_name,
        threads=launch.threads,
        codewords_per_cta=cw_per_cta,
        smem_bytes_per_cta=launch.smem_bytes,
        smem_bytes_per_cw=own,
        registers=registers,
        ctas_per_sm=ctas,
        resident_codewords=ctas * card.H100_SMS * cw_per_cta,
        bytes_per_cw=per_cw,
        batch=batch,
        alloc_bytes=batch * per_cw + _table_bytes(code, impl) + counter,
    )


def memory_table(batch: int = 16384) -> list[DecoderMemory]:
    """Every code, kernel and dtype form."""
    rows = []
    for code in ALL_CODES:
        for impl in IMPLS:
            if impl in ("cuda_layered", "cuda_qc"):
                rows.extend(decoder_memory(code, impl, dt, batch) for dt in cuda_layered.FORMS)
            else:
                rows.append(decoder_memory(code, impl, torch.float32, batch))
    return rows


def _fmt_bytes(b: float) -> str:
    if b >= 1 << 20:
        return f"{b / (1 << 20):.1f} MiB"
    if b >= 1 << 10:
        return f"{b / (1 << 10):.1f} KiB"
    return f"{int(b)} B"


def format_memory_table(rows: list[DecoderMemory] | None = None) -> str:
    """Markdown table a user can size batches from, one H100."""
    if rows is None:
        rows = memory_table()
    lines = [
        "| code | impl | LLR dtype | threads/CTA | cw/CTA | shared/CTA | shared/cw "
        "| CTAs/SM (regs) | resident cw | B/cw/decode | alloc for batch |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        lines.append(
            f"| {r.code} | {r.impl} | {r.dtype} | {r.threads} | {r.codewords_per_cta}"
            f" | {_fmt_bytes(r.smem_bytes_per_cta)} | {r.smem_bytes_per_cw:,}"
            f" | {r.ctas_per_sm} ({r.registers}) | {r.resident_codewords:,}"
            f" | {r.bytes_per_cw:,} | {_fmt_bytes(r.alloc_bytes)} (B={r.batch}) |"
        )
    return "\n".join(lines)


def format_reference_table() -> str:
    """The reference crate-docs RAM table (src/lib.rs:146-200): per-code
    working-area and output sizes from the documented formulas
    (src/codes/mod.rs:91-105, kept as CodeParams properties)."""
    lines = [
        "| code | n | k | output bytes | bf working (u8) "
        "| ms working i8 | ms working f32 | ms working u8 |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for code in ALL_CODES:
        p = code.params
        w = p.decode_ms_working_len
        lines.append(
            f"| {code.name} | {p.n} | {p.k} | {p.output_len}"
            f" | {p.decode_bf_working_len} | {w} | {4 * w}"
            f" | {p.decode_ms_working_u8_len} |"
        )
    return "\n".join(lines)
