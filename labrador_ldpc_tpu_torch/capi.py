"""ctypes bindings for the native scalar codec (`native/labrador_ldpc.cpp`).

The port's own copy of `labrador_ldpc_tpu/capi.py`, keyed on the port's
`codes.params.LDPCCode`: the C-callable host codec of the reference crate's
FFI (capi/src/lib.rs, capi/include/labrador_ldpc.h) for one codeword at a
time, on the CPU, with the same names and ctypes signatures.

The library is built at first use, never at import, from the checkout's
`native/labrador_ldpc.cpp` with the JAX package's g++ flags, into
`labrador_ldpc_tpu_torch/_build/` under a name that carries a hash of the
sources and the flags (as `ops/_nvcc.py` names the CUDA builds). It is
written under a temporary name and moved into place with `os.replace`, so a
process never loads a half-written library. The constants it compiles in are
the tracked `native/constants_data.inc`; the script that regenerates them
(`native/gen_constants.py`) imports the JAX package, so a missing file
raises here instead.

    from labrador_ldpc_tpu_torch import capi
    cw = capi.copy_encode("TC128", data_bytes)         # np.uint8 (n/8,)
    ok, iters, out = capi.decode_ms("TC128", llrs_f32) # np.float32 (n,)
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from functools import lru_cache
from pathlib import Path

import numpy as np

from .codes.params import LDPCCode, get_code
from .ops._nvcc import BUILD_DIR

__all__ = [
    "lib",
    "encode",
    "copy_encode",
    "decode_bf",
    "decode_ms",
    "hard_to_llrs",
    "llrs_to_hard",
]

NATIVE_DIR = Path(__file__).resolve().parents[1] / "native"
SOURCE = NATIVE_DIR / "labrador_ldpc.cpp"
# every file the build reads: the source includes the other two
INPUTS = (SOURCE, NATIVE_DIR / "labrador_ldpc.h", NATIVE_DIR / "constants_data.inc")
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-fno-exceptions")

_CODE_INDEX = {c: i for i, c in enumerate(LDPCCode)}

_MS_TYPES = {
    np.dtype(np.int8): ("i8", ctypes.c_int8),
    np.dtype(np.int16): ("i16", ctypes.c_int16),
    np.dtype(np.float32): ("f32", ctypes.c_float),
    np.dtype(np.float64): ("f64", ctypes.c_double),
}


def build() -> Path:
    """Compile the native codec with g++ unless that build exists already;
    returns the shared library's path."""
    for path in INPUTS:
        if not path.exists():
            raise FileNotFoundError(
                f"{path} is missing: the native codec builds from the tracked sources "
                "(constants_data.inc is written by native/gen_constants.py)")
    h = hashlib.sha256()
    for path in INPUTS:
        h.update(path.name.encode() + path.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    so = BUILD_DIR / f"liblabrador_ldpc-{h.hexdigest()[:16]}.so"
    if so.exists():
        return so
    cxx = shutil.which("g++")
    if cxx is None:
        raise FileNotFoundError("g++ not found: the native codec is built with g++")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {SOURCE} (exit {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    return so


@lru_cache(maxsize=1)
def _load() -> ctypes.CDLL:
    l = ctypes.CDLL(str(build()))
    for name in (
        "code_n", "code_k", "punctured_bits", "paritycheck_sum",
        "bf_working_len", "ms_working_len", "ms_working_u8_len", "output_len",
    ):
        fn = getattr(l, f"labrador_ldpc_{name}")
        fn.restype = ctypes.c_size_t
        fn.argtypes = [ctypes.c_int]

    # every entry point's restype and argtypes: the decoders return C++ bool
    # and take size_t and pointer arguments, which ctypes' c_int defaults
    # would pass wrongly
    u8p = ctypes.POINTER(ctypes.c_uint8)
    szp = ctypes.POINTER(ctypes.c_size_t)
    l.labrador_ldpc_encode.restype = None
    l.labrador_ldpc_encode.argtypes = [ctypes.c_int, u8p]
    l.labrador_ldpc_copy_encode.restype = None
    l.labrador_ldpc_copy_encode.argtypes = [ctypes.c_int, u8p, u8p]
    l.labrador_ldpc_decode_bf.restype = ctypes.c_bool
    l.labrador_ldpc_decode_bf.argtypes = [
        ctypes.c_int, u8p, u8p, u8p, ctypes.c_size_t, szp,
    ]
    for suffix, ctype in (
        ("i8", ctypes.c_int8), ("i16", ctypes.c_int16),
        ("f32", ctypes.c_float), ("f64", ctypes.c_double),
    ):
        tp = ctypes.POINTER(ctype)
        ms = getattr(l, f"labrador_ldpc_decode_ms_{suffix}")
        ms.restype = ctypes.c_bool
        ms.argtypes = [ctypes.c_int, tp, u8p, tp, u8p, ctypes.c_size_t, szp]
        h2l = getattr(l, f"labrador_ldpc_hard_to_llrs_{suffix}")
        h2l.restype = None
        h2l.argtypes = [ctypes.c_int, u8p, tp]
        l2h = getattr(l, f"labrador_ldpc_llrs_to_hard_{suffix}")
        l2h.restype = None
        l2h.argtypes = [ctypes.c_int, tp, u8p]
    return l


def lib() -> ctypes.CDLL:
    """The loaded native library (building it first if necessary)."""
    return _load()


def _u8(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.uint8)


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _size(a: np.ndarray, want: int, what: str) -> None:
    if a.size != want:
        raise ValueError(f"{what} must hold {want} elements, got {a.size}")


def encode(code: LDPCCode | str, codeword: np.ndarray) -> np.ndarray:
    """In-place systematic encode: codeword (n/8,) with data in first k/8."""
    code = get_code(code)
    l = _load()
    cw = _u8(codeword).copy()
    _size(cw, code.n // 8, "the codeword")
    l.labrador_ldpc_encode(_CODE_INDEX[code], _ptr(cw, ctypes.c_uint8))
    return cw


def copy_encode(code: LDPCCode | str, data: np.ndarray) -> np.ndarray:
    """data (k/8,) bytes -> codeword (n/8,) bytes."""
    code = get_code(code)
    l = _load()
    data = _u8(data)
    _size(data, code.k // 8, "the data")
    cw = np.zeros(code.n // 8, dtype=np.uint8)
    l.labrador_ldpc_copy_encode(
        _CODE_INDEX[code], _ptr(data, ctypes.c_uint8), _ptr(cw, ctypes.c_uint8)
    )
    return cw


def decode_bf(code: LDPCCode | str, input_bytes: np.ndarray, maxiters: int = 20):
    """Hard bit-flip decode. Returns (success, iters, output_bytes)."""
    code = get_code(code)
    l = _load()
    inp = _u8(input_bytes)
    _size(inp, code.n // 8, "the input")
    idx = _CODE_INDEX[code]
    out = np.zeros(int(l.labrador_ldpc_output_len(idx)), dtype=np.uint8)
    work = np.zeros(int(l.labrador_ldpc_bf_working_len(idx)), dtype=np.uint8)
    iters = ctypes.c_size_t(0)
    ok = l.labrador_ldpc_decode_bf(
        idx, _ptr(inp, ctypes.c_uint8), _ptr(out, ctypes.c_uint8),
        _ptr(work, ctypes.c_uint8), ctypes.c_size_t(maxiters), ctypes.byref(iters),
    )
    return bool(ok), int(iters.value), out


def decode_ms(code: LDPCCode | str, llrs: np.ndarray, maxiters: int = 20):
    """Soft min-sum decode (i8/i16/f32/f64 LLRs).

    Returns (success, iters, output_bytes)."""
    code = get_code(code)
    l = _load()
    llrs = np.ascontiguousarray(llrs)
    if llrs.dtype not in _MS_TYPES:
        raise ValueError(f"LLRs must be int8, int16, float32 or float64, got {llrs.dtype}")
    suffix, ctype = _MS_TYPES[llrs.dtype]
    _size(llrs, code.n, "the LLRs")
    idx = _CODE_INDEX[code]
    out = np.zeros(int(l.labrador_ldpc_output_len(idx)), dtype=np.uint8)
    work = np.zeros(int(l.labrador_ldpc_ms_working_len(idx)), dtype=llrs.dtype)
    work_u8 = np.zeros(int(l.labrador_ldpc_ms_working_u8_len(idx)), dtype=np.uint8)
    iters = ctypes.c_size_t(0)
    fn = getattr(l, f"labrador_ldpc_decode_ms_{suffix}")
    ok = fn(
        idx, _ptr(llrs, ctype), _ptr(out, ctypes.c_uint8), _ptr(work, ctype),
        _ptr(work_u8, ctypes.c_uint8), ctypes.c_size_t(maxiters), ctypes.byref(iters),
    )
    return bool(ok), int(iters.value), out


def hard_to_llrs(code: LDPCCode | str, input_bytes: np.ndarray, dtype=np.float32) -> np.ndarray:
    """(n/8,) hard bytes -> (n,) LLRs of +-1 in `dtype`."""
    code = get_code(code)
    l = _load()
    suffix, ctype = _MS_TYPES[np.dtype(dtype)]
    inp = _u8(input_bytes)
    _size(inp, code.n // 8, "the input")
    llrs = np.zeros(code.n, dtype=dtype)
    getattr(l, f"labrador_ldpc_hard_to_llrs_{suffix}")(
        _CODE_INDEX[code], _ptr(inp, ctypes.c_uint8), _ptr(llrs, ctype)
    )
    return llrs


def llrs_to_hard(code: LDPCCode | str, llrs: np.ndarray) -> np.ndarray:
    """(n,) LLRs -> (n/8,) hard bytes (negative -> bit 1)."""
    code = get_code(code)
    l = _load()
    llrs = np.ascontiguousarray(llrs)
    suffix, ctype = _MS_TYPES[llrs.dtype]
    _size(llrs, code.n, "the LLRs")
    out = np.zeros(code.n // 8, dtype=np.uint8)
    getattr(l, f"labrador_ldpc_llrs_to_hard_{suffix}")(
        _CODE_INDEX[code], _ptr(llrs, ctype), _ptr(out, ctypes.c_uint8)
    )
    return out
