"""Hand-written CUDA kernel for the row-layered self-corrected min-sum decode.

Wraps `csrc/layered_minsum.cu`, the Hopper port of the two TPU kernels of
the main path (labrador_ldpc_tpu/ops/pallas_qc.py:728
make_ms_decoder_pallas_layered and labrador_ldpc_tpu/ops/pallas_tc.py:268
make_ms_decoder_pallas_tc_layered), for all nine codes, in float32, in the
TPU kernels' bfloat16 form (bfloat16 storage, float32 arithmetic) and in the
saturating int8/int16 forms (one C entry point per dtype).

On a CPU tensor the wrapper runs the plain version
(`qc_minsum.layered_minsum_plain`); on a CUDA tensor it launches the kernel
or raises. `launches` counts kernel launches and nothing else;
`form_launches` splits the same count by dtype form ("f32", "bf16", "i8",
"i16"). float64 LLRs raise a ValueError, as the TPU kernels refuse them.

The kernel keeps a codeword's whole state in shared memory and allocates
nothing; the wrapper allocates the outputs only. Its launch shape comes from
`launch_config` (plain Python, no card needed), the addend table from
`addend_descriptors`, and the windows of its syndrome on packed hard
decisions from `syndrome_windows`; the C side checks the shape against the
code.
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
from .minsum import MSResult
from .qc_minsum import KERNEL_DTYPES, check_llrs, layered_minsum_plain
from .routing import route_for

__all__ = ["make_ms_decoder_cuda_layered", "layered_minsum", "addend_table",
           "addend_descriptors", "syndrome_windows", "packed_words", "launch_config",
           "card_ctas_per_sm", "FORMS", "SOURCE"]

SOURCE = "layered_minsum.cu"

# the kernels' dtype forms: the suffix of each C entry point
FORMS = {torch.float32: "f32", torch.bfloat16: "bf16", torch.int8: "i8", torch.int16: "i16"}

# H100 (sm_90) shared memory: an SM's 228 KiB, the runtime's 1 KiB reserved
# per resident CTA, and the 227 KiB one CTA can address
SM_SHARED_BYTES = 233_472
CTA_RESERVED_BYTES = 1_024
CTA_SHARED_MAX = 232_448
MAX_CTAS_PER_SM = 32
# threads an SM runs at the kernel's register budget: __launch_bounds__(1024)
# gives a thread at most 64 of the SM's 65,536 registers
THREADS_PER_SM = 1_024
MAX_THREADS = 1_024
CHECKS_PER_THREAD = (1, 2, 4)  # the kernel's instances

# kernel launches since import; read and reset as `cuda_layered.launches`
launches = 0
# the same launches by dtype form; reset with `launches`
form_launches = dict.fromkeys(FORMS.values(), 0)


def addend_table(s: QCStructure) -> tuple[np.ndarray, np.ndarray]:
    """The kernel's view of `qc_structure`: (sumA, 9) int32 rows of
    (row, col, kind 0=rot/1=pi, shift, theta, phi0..phi3), and the (R+1,)
    int32 offsets of each layer's first addend."""
    rows, off = [], [0]
    for row in s.rows:
        for p in row:
            phis = tuple(p.phis) if p.kind == "pi" else (0, 0, 0, 0)
            rows.append((p.row, p.col, 0 if p.kind == "rot" else 1, p.shift, p.theta, *phis))
        off.append(off[-1] + len(row))
    return np.asarray(rows, dtype=np.int32), np.asarray(off, dtype=np.int32)


def addend_descriptors(s: QCStructure) -> np.ndarray:
    """The layered kernel's view of `qc_structure`: (sumA, 2) int32 words per
    addend, which its threads keep in registers.

    lo = col | kind << 4 | theta << 5 | s0 << 7 | run_end << 19, with kind 0
    for a rotation (s0 its shift mod M) and 1 for a pi permutation (s0 its
    phi0 mod M/4); hi = phi1 | phi2 << 10 | phi3 << 20 (mod M/4; 0 for a
    rotation). A layer's addends fall into runs on distinct block columns: a
    run ends before an addend whose column the run has written already, and
    `run_end` is the index of the addend after this one's run. Pass 2 of the
    kernel synchronises between runs, and only there."""
    m, q = s.m, s.m // 4
    out, ends, e = [], [], 0
    for row in s.rows:
        written: set[int] = set()
        for p in row:
            if p.col in written:  # a new run starts here
                ends.extend([e] * (len(out) - len(ends)))
                written = set()
            written.add(p.col)
            if p.kind == "rot":
                s0, hi = p.shift % m, 0
            else:
                phis = [phi % q for phi in p.phis]
                s0, hi = phis[0], phis[1] | phis[2] << 10 | phis[3] << 20
            kind = 0 if p.kind == "rot" else 1
            out.append((p.col | kind << 4 | p.theta << 5 | s0 << 7, hi))
            e += 1
        ends.extend([e] * (len(out) - len(ends)))
    return np.asarray([(lo | end << 19, hi) for (lo, hi), end in zip(out, ends)], dtype=np.int32)


def packed_words(m: int) -> int:
    """Words of a packed block column or row of checks: M/32, and one for
    M = 16 (TC128), which holds its 16 bits twice over."""
    return max(1, m // 32)


def syndrome_windows(s: QCStructure) -> np.ndarray:
    """The kernel's syndrome table: (sumA, W) int32 window entries in row
    order, W = `packed_words(M)`, the bit-flip kernel's forward entries
    (`cuda_bf.window_table`): entry (e, j) is the 32-bit window of addend e's
    packed block column that checks 32*j onward of its row read, b | w0 << 5
    | w1 << 18 (the window's first bit b in word w0, continued in w1). Check
    word j of a row is the XOR of its addends' windows j.

    A window stays inside the addend's segment, the block for a rotation
    and a quarter of it for a pi permutation, so M must be at least 16 and
    a pi permutation's M/4 at least 32."""
    from .cuda_bf import window_table  # that module imports this one

    if s.m < 16 or s.m & (s.m - 1):
        raise ValueError(f"the CUDA layered kernel's syndrome needs a power-of-two M >= 16, "
                         f"got {s.m}")
    if s.m < 128 and any(p.kind == "pi" for row in s.rows for p in row):
        raise ValueError(f"the CUDA layered kernel's syndrome needs M/4 >= 32 for a pi "
                         f"permutation, got M = {s.m}")
    return window_table(s)[0]


def _shape(code: LDPCCode) -> tuple[int, int, int, int, int]:
    """M, R, Cc, sumA and the widest layer's addend count of `code`."""
    s = qc_structure(code)
    return s.m, s.n_block_rows, s.n_block_cols, sum(map(len, s.rows)), max(map(len, s.rows))


def launch_config(code: LDPCCode | str, dtype: torch.dtype = torch.float32) -> dict:
    """The kernel's launch shape for `code` and an LLR dtype, on an H100:
    threads and checks a thread per CTA (one CTA per codeword), its dynamic
    shared bytes, the CTAs that fit on one SM, and the work of the syndrome
    a sweep: `syndrome_words` check words of 32 checks (R*W, W =
    `packed_words(M)`) from `syndrome_windows` windows (sumA*W).

    Shared bytes: the posteriors (Cc*M of 4 bytes, of 2 in the bf16 form),
    t' (sumA*M), m1 and m2 (2*R*M, all of the LLRs' type), the sign
    products (R*M/32 words, rounded up) and the hard decisions (Cc*W
    words), a bit a check or variable. The threads are the largest power of
    two, at most M (at least one warp) and 1024, that keeps the CTAs shared
    memory allows within THREADS_PER_SM, so that registers hold no fewer
    CTAs on an SM than shared memory does; but a thread takes at most four
    checks (more spill registers), and where that needs more threads (TM2048
    int8), the register budget sets the CTAs an SM holds."""
    code = get_code(code)
    if dtype not in FORMS:
        raise ValueError(f"the CUDA layered kernel takes {list(FORMS)}, got {dtype}")
    M, R, Cc, sumA, _ = _shape(code)
    size = torch.empty((), dtype=dtype).element_size()
    va_size = 2 if dtype == torch.bfloat16 else 4
    W = packed_words(M)
    smem = Cc * M * va_size + (sumA + 2 * R) * M * size + 4 * (-(-R * M // 32) + Cc * W)
    if smem > CTA_SHARED_MAX:
        raise ValueError(f"{code} needs {smem} B of shared memory, over {CTA_SHARED_MAX}")
    ctas = min(MAX_CTAS_PER_SM, SM_SHARED_BYTES // (smem + CTA_RESERVED_BYTES))
    budget = THREADS_PER_SM // ctas
    threads = max(32, M // CHECKS_PER_THREAD[-1],
                  min(M, MAX_THREADS, 1 << (budget.bit_length() - 1)))
    return dict(threads=threads, checks_per_thread=max(1, M // threads), smem_bytes=smem,
                ctas_per_sm=min(ctas, THREADS_PER_SM // threads), syndrome_words=R * W,
                syndrome_windows=sumA * W)


@lru_cache(maxsize=None)
def _kernel_tables(code: LDPCCode, device: torch.device):
    """The packed addends and the (R+1,) layer offsets on the device."""
    s = qc_structure(code)
    _, off = addend_table(s)
    return (torch.as_tensor(addend_descriptors(s), device=device),
            torch.as_tensor(off, device=device))


@lru_cache(maxsize=None)
def _syndrome_table(code: LDPCCode, device: torch.device) -> torch.Tensor:
    """`syndrome_windows` on the device."""
    return torch.as_tensor(syndrome_windows(qc_structure(code)), device=device)


@lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for form in FORMS.values():
        fn = getattr(lib, f"layered_minsum_{form}")
        fn.argtypes = [ptr] * 7 + [i32] * 9 + [ctypes.c_float] + [i32] * 3 + [ptr]
        fn.restype = i32
        occ = getattr(lib, f"layered_minsum_{form}_ctas_per_sm")
        occ.argtypes = [i32] * 8 + [ctypes.POINTER(i32)]
        occ.restype = i32
    return lib


def card_ctas_per_sm(code: LDPCCode | str, dtype: torch.dtype = torch.float32) -> int:
    """The CTAs of `launch_config(code, dtype)` that fit on one SM of the
    current card, as the CUDA runtime's occupancy calculator reports them."""
    code = get_code(code)
    cfg = launch_config(code, dtype)
    out = ctypes.c_int()
    err = getattr(_lib(), f"layered_minsum_{FORMS[dtype]}_ctas_per_sm")(
        *_shape(code), cfg["threads"], cfg["checks_per_thread"], cfg["smem_bytes"],
        ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"layered_minsum_{FORMS[dtype]}_ctas_per_sm failed with CUDA error {err}")
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
    desc, off = _kernel_tables(code, dev)
    win = _syndrome_table(code, dev)
    cfg = launch_config(code, llrs.dtype)
    form = FORMS[llrs.dtype]
    fn = getattr(_lib(), f"layered_minsum_{form}")
    with torch.cuda.device(dev):
        err = fn(
            llrs.data_ptr(), bits.data_ptr(), success.data_ptr(), iterations.data_ptr(),
            desc.data_ptr(), off.data_ptr(), win.data_ptr(), B, n, M, R, Cc, sumA, row_max,
            maxiters, 0 if alpha is None else 1, 0.0 if alpha is None else float(alpha),
            cfg["threads"], cfg["checks_per_thread"], cfg["smem_bytes"],
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"layered_minsum_{form} launch failed with CUDA error {err}")
    launches += 1
    form_launches[form] += 1
    return MSResult(success, iterations, bits)


def layered_minsum(code: LDPCCode | str, llrs: torch.Tensor, maxiters: int,
                   alpha: float | None = None) -> MSResult:
    """Decode (B, n) float32, bfloat16, int8 or int16 LLRs where they lie: the
    kernel on CUDA, the plain version on the CPU."""
    code = get_code(code)
    check_llrs(llrs, code.n, alpha, KERNEL_DTYPES)
    if llrs.device.type == "cuda":
        return _launch(code, llrs, maxiters, alpha)
    if llrs.device.type == "cpu":
        return layered_minsum_plain(qc_structure(code), llrs, maxiters, alpha)
    raise ValueError(f"layered_minsum takes CUDA or CPU tensors, got {llrs.device}")


def make_ms_decoder_cuda_layered(
    code: LDPCCode | str,
    maxiters: int = 20,
    alpha: float | None = None,
    device="cuda",
):
    """Row-layered self-corrected min-sum decoder through the CUDA kernel.

    Returns fn(llrs: (B, n) float32, bfloat16, int8 or int16) -> MSResult, run
    on `device`; `device="cpu"` runs the plain version. `alpha` needs float
    LLRs (a float32 alpha, as the TPU kernels', also for bfloat16).
    """
    code = get_code(code)
    route_for(code)  # an unrouted code fails here, before any launch
    dev = resolve_device(device)

    def decode(llrs) -> MSResult:
        return layered_minsum(code, torch.as_tensor(llrs, device=dev), maxiters, alpha)

    return decode
