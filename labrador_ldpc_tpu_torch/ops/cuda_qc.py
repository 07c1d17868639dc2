"""Hand-written CUDA kernel for the flooding self-corrected min-sum decode.

Wraps `csrc/flooding_minsum.cu`, the Hopper port of the two TPU flooding
kernels (labrador_ldpc_tpu/ops/pallas_qc.py:265 make_ms_decoder_pallas_qc and
labrador_ldpc_tpu/ops/pallas_tc.py:506 make_ms_decoder_pallas_tc_qc), for all
nine codes, in float32 and bfloat16 (with alpha; bfloat16 storage, float32
arithmetic, as the TPU kernels) and in the saturating int8/int16 forms (one C
entry point per dtype). impl "cuda_qc" of the decoder registry.

On a CPU tensor the wrapper runs the plain version
(`qc_minsum.flooding_minsum_plain`); on a CUDA tensor it launches the kernel
or raises. `launches` counts kernel launches and nothing else;
`form_launches` splits the same count by dtype form ("f32", "bf16", "i8",
"i16"). float64 LLRs raise a ValueError, as the TPU kernels refuse them.

The kernel keeps a codeword's posteriors, LLRs and each edge's variable
index in shared memory and its check statistics in the registers of one
owner thread per check; it allocates nothing, and the wrapper allocates the
outputs only. Its launch shape comes from `launch_config` (plain Python, no
card needed), its tables from `cuda_layered.addend_descriptors` and
`flooding_runs` (sweep 1's order, the runs of `flooding_schedule`); the C
side checks both against the code.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from ..codes.expand import QCStructure, qc_structure
from ..codes.params import LDPCCode, get_code
from ..device import resolve_device
from ._nvcc import load_library
from .cuda_layered import CTA_SHARED_MAX, FORMS, _shape, addend_descriptors, addend_table
from .cuda_sp import REGISTERS_PER_THREAD, ctas_per_sm
from .minsum import MSResult
from .qc_minsum import KERNEL_DTYPES, check_llrs, flooding_minsum_plain
from .routing import route_for

__all__ = ["make_ms_decoder_cuda_qc", "flooding_minsum", "flooding_schedule", "flooding_runs",
           "launch_config", "card_ctas_per_sm", "INSTANCES", "SOURCE"]

SOURCE = "flooding_minsum.cu"

# the kernel's instances, by the widest row of a code: checks a thread, two
# where a block row has more checks than a CTA threads (TM8192, and TM2048
# with it), else one
INSTANCES = {6: 2, 8: 1, 10: 1, 18: 1}

# kernel launches since import; read and reset as `cuda_qc.launches`
launches = 0
# the same launches by dtype form; reset with `launches`
form_launches = dict.fromkeys(FORMS.values(), 0)


def flooding_schedule(s: QCStructure) -> tuple[list[int], list[int]]:
    """Sweep 1's order: the addend indices run by run, run k holding the
    k-th addend (in addend order) of every block column, and the end of each
    run in that order. The twin adds the u of a column's addends in addend
    order and nothing else depends on the order, so each run touches a
    column at most once and needs no barrier inside."""
    cols = [p.col for row in s.rows for p in row]
    rank, seen = [], {}
    for c in cols:
        rank.append(seen.get(c, 0))
        seen[c] = rank[-1] + 1
    order = sorted(range(len(cols)), key=lambda e: (rank[e], e))
    ends = np.cumsum(np.bincount(rank)).tolist()
    return order, ends


def flooding_runs(s: QCStructure) -> np.ndarray:
    """Sweep 1's order as the kernel holds it, one (sumA,) int32 word a step:
    e | row << 6 | pos << 8 | run_end << 13, with e the addend, row and pos
    its block row and its place in the row, and run_end the end of its run
    in `flooding_schedule` order."""
    _, off = addend_table(s)
    order, ends = flooding_schedule(s)
    words = []
    for k, e in enumerate(order):
        row = int(np.searchsorted(off, e, side="right")) - 1
        end = next(x for x in ends if x > k)
        words.append(e | row << 6 | (e - int(off[row])) << 8 | end << 13)
    return np.asarray(words, dtype=np.int32)


def launch_config(code: LDPCCode | str, dtype: torch.dtype = torch.float32,
                  registers: int = REGISTERS_PER_THREAD) -> dict:
    """The kernel's launch shape for `code` and an LLR dtype on an H100:
    threads and checks a thread per CTA (one CTA per codeword, one owner
    thread per check), its dynamic shared bytes, the CTAs that fit on one SM
    when a thread takes `registers` registers (the kernel's budget by
    default; ptxas's count of the instance gives the card's), and sweep 1's
    runs and the barriers an iteration (one after each run, one after sweep
    2).

    Shared bytes: two planes of Cc*M values of the LLRs' dtype, the
    posteriors and the LLRs (punctured tail 0), and each edge's variable
    index, sumA*M of 2 bytes; the check statistics live in the owners'
    registers."""
    code = get_code(code)
    if dtype not in FORMS:
        raise ValueError(f"the CUDA flooding kernel takes {list(FORMS)}, got {dtype}")
    M, _, Cc, sumA, row_max = _shape(code)
    if row_max not in INSTANCES:
        raise ValueError(f"{code}: no kernel instance for rows of {row_max} addends")
    checks = INSTANCES[row_max]
    threads = max(32, M // checks)  # below 32 checks: one warp, lanes past M idle
    smem = 2 * Cc * M * torch.empty((), dtype=dtype).element_size() + 2 * sumA * M
    if smem > CTA_SHARED_MAX:
        raise ValueError(f"{code} needs {smem} B of shared memory, over {CTA_SHARED_MAX}")
    runs = len(flooding_schedule(qc_structure(code))[1])
    return dict(threads=threads, checks_per_thread=checks, smem_bytes=smem,
                ctas_per_sm=ctas_per_sm(smem, threads, registers), runs=runs,
                barriers_per_iteration=runs + 1)


@lru_cache(maxsize=None)
def _kernel_tables(code: LDPCCode, device: torch.device):
    """The packed addends, sweep 1's run words and the (R+1,) row offsets on
    the device."""
    s = qc_structure(code)
    _, off = addend_table(s)
    return tuple(torch.as_tensor(a, device=device)
                 for a in (addend_descriptors(s), flooding_runs(s), off))


@lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for form in FORMS.values():
        fn = getattr(lib, f"flooding_minsum_{form}")
        fn.argtypes = [ptr] * 7 + [i32] * 9 + [ctypes.c_float] + [i32] * 3 + [ptr]
        fn.restype = i32
        occ = getattr(lib, f"flooding_minsum_{form}_ctas_per_sm")
        occ.argtypes = [i32] * 9 + [ctypes.POINTER(i32)]
        occ.restype = i32
    return lib


def card_ctas_per_sm(code: LDPCCode | str, dtype: torch.dtype = torch.float32) -> int:
    """The CTAs of `launch_config(code, dtype)` that fit on one SM of the
    current card, as the CUDA runtime's occupancy calculator reports them."""
    code = get_code(code)
    cfg = launch_config(code, dtype)
    out = ctypes.c_int()
    name = f"flooding_minsum_{FORMS[dtype]}_ctas_per_sm"
    err = getattr(_lib(), name)(*_shape(code), code.n, cfg["threads"], cfg["checks_per_thread"],
                                cfg["smem_bytes"], ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"{name} failed with CUDA error {err}")
    return out.value


def _launch(code: LDPCCode, llrs: torch.Tensor, maxiters: int, alpha: float | None) -> MSResult:
    global launches
    M, R, Cc, sumA, row_max = _shape(code)
    B, n = llrs.shape
    dev = llrs.device
    llrs = llrs.contiguous()
    bits = torch.empty((B, Cc * M), dtype=torch.uint8, device=dev)
    success = torch.empty((B,), dtype=torch.bool, device=dev)
    iterations = torch.empty((B,), dtype=torch.int32, device=dev)
    if B == 0:
        return MSResult(success, iterations, bits)
    desc, runs, off = _kernel_tables(code, dev)
    cfg = launch_config(code, llrs.dtype)
    form = FORMS[llrs.dtype]
    fn = getattr(_lib(), f"flooding_minsum_{form}")
    with torch.cuda.device(dev):
        err = fn(
            llrs.data_ptr(), bits.data_ptr(), success.data_ptr(), iterations.data_ptr(),
            desc.data_ptr(), runs.data_ptr(), off.data_ptr(), B, n, M, R, Cc, sumA, row_max,
            maxiters,
            0 if alpha is None else 1, 0.0 if alpha is None else float(alpha),
            cfg["threads"], cfg["checks_per_thread"], cfg["smem_bytes"],
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"flooding_minsum_{form} launch failed with CUDA error {err}")
    launches += 1
    form_launches[form] += 1
    return MSResult(success, iterations, bits)


def flooding_minsum(code: LDPCCode | str, llrs: torch.Tensor, maxiters: int,
                    alpha: float | None = None) -> MSResult:
    """Decode (B, n) float32, bfloat16, int8 or int16 LLRs where they lie: the
    kernel on CUDA, the plain version on the CPU."""
    code = get_code(code)
    check_llrs(llrs, code.n, alpha, KERNEL_DTYPES)
    if llrs.device.type == "cuda":
        return _launch(code, llrs, maxiters, alpha)
    if llrs.device.type == "cpu":
        return flooding_minsum_plain(qc_structure(code), llrs, maxiters, alpha)
    raise ValueError(f"flooding_minsum takes CUDA or CPU tensors, got {llrs.device}")


def make_ms_decoder_cuda_qc(
    code: LDPCCode | str,
    maxiters: int = 20,
    alpha: float | None = None,
    device="cuda",
):
    """Flooding self-corrected min-sum decoder through the CUDA kernel.

    Returns fn(llrs: (B, n) float32, bfloat16, int8 or int16) -> MSResult, run
    on `device`; `device="cpu"` runs the plain version. float32 is
    `make_ms_decoder_qc`'s function (bfloat16 too without alpha; with alpha
    the kernel keeps alpha in float32, as the TPU kernels), int8/int16
    `make_ms_decoder_qc_int`'s; `alpha` needs float LLRs.
    """
    code = get_code(code)
    route_for(code)  # an unrouted code fails here, before any launch
    dev = resolve_device(device)

    def decode(llrs) -> MSResult:
        return flooding_minsum(code, torch.as_tensor(llrs, device=dev), maxiters, alpha)

    return decode
