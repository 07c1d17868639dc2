"""Code registry: the nine CCSDS LDPC codes and their parameters.

The port's own copy of `labrador_ldpc_tpu/codes/params.py`: the counterpart
of the reference crate's ``LDPCCode`` enum and
``CodeParams`` struct (reference: src/codes/mod.rs:39-106 and the nine
``*_PARAMS`` consts at src/codes/mod.rs:109-241). The working-area length
fields of the reference are caller-buffer bookkeeping for a no-alloc
embedded target; here the framework owns all memory, so we keep them only as derived
properties for parity with the reference's documented size formulas
(src/codes/mod.rs:91-105).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from functools import lru_cache


class LDPCCode(enum.Enum):
    """The nine CCSDS LDPC codes.

    TC codes: CCSDS 231.1-O-1 telecommand, rate 1/2.
    TM codes: CCSDS 131.0-B-2 telemetry, rates 1/2, 2/3, 4/5.
    (reference: src/codes/mod.rs:39-66)
    """

    TC128 = "TC128"
    TC256 = "TC256"
    TC512 = "TC512"
    TM1280 = "TM1280"
    TM1536 = "TM1536"
    TM2048 = "TM2048"
    TM5120 = "TM5120"
    TM6144 = "TM6144"
    TM8192 = "TM8192"

    # -- accessors mirroring the reference's inherent methods -------------
    @property
    def params(self) -> "CodeParams":
        return CODE_PARAMS[self]

    @property
    def n(self) -> int:
        return self.params.n

    @property
    def k(self) -> int:
        return self.params.k

    @property
    def punctured_bits(self) -> int:
        return self.params.punctured_bits

    @property
    def submatrix_size(self) -> int:
        return self.params.submatrix_size

    @property
    def circulant_size(self) -> int:
        return self.params.circulant_size

    @property
    def paritycheck_sum(self) -> int:
        return self.params.paritycheck_sum

    @property
    def is_punctured(self) -> bool:
        return self.params.punctured_bits > 0

    def __str__(self) -> str:  # "TC128" etc.
        return self.value


@dataclass(frozen=True)
class CodeParams:
    """Static parameters of one code (reference: src/codes/mod.rs:69-106)."""

    n: int  # codeword bits transmitted
    k: int  # information bits
    punctured_bits: int  # parity bits never transmitted
    submatrix_size: int  # M: size of H prototype sub-blocks
    circulant_size: int  # generator circulant block size
    paritycheck_sum: int  # |E|: number of edges in H

    # -- derived sizes (documentation parity with src/codes/mod.rs:91-105) --
    @property
    def rate(self) -> float:
        return self.k / self.n

    @property
    def n_checks(self) -> int:
        """Number of parity-check rows of the expanded H: n + p - k."""
        return self.n + self.punctured_bits - self.k

    @property
    def n_vars(self) -> int:
        """Number of variable nodes of the expanded H: n + p."""
        return self.n + self.punctured_bits

    @property
    def decode_bf_working_len(self) -> int:
        return self.n + self.punctured_bits

    @property
    def decode_ms_working_len(self) -> int:
        return 2 * self.paritycheck_sum + 3 * self.n + 3 * self.punctured_bits - 2 * self.k

    @property
    def decode_ms_working_u8_len(self) -> int:
        return (self.n + self.punctured_bits - self.k) // 8

    @property
    def output_len(self) -> int:
        """Decoder output bytes: (n + p) / 8."""
        return (self.n + self.punctured_bits) // 8


CODE_PARAMS: dict[LDPCCode, CodeParams] = {
    # values pinned against reference src/codes/mod.rs:109-241
    LDPCCode.TC128: CodeParams(128, 64, 0, 16, 16, 512),
    LDPCCode.TC256: CodeParams(256, 128, 0, 32, 32, 1024),
    LDPCCode.TC512: CodeParams(512, 256, 0, 64, 64, 2048),
    LDPCCode.TM1280: CodeParams(1280, 1024, 128, 128, 32, 4992),
    LDPCCode.TM1536: CodeParams(1536, 1024, 256, 256, 64, 5888),
    LDPCCode.TM2048: CodeParams(2048, 1024, 512, 512, 128, 7680),
    LDPCCode.TM5120: CodeParams(5120, 4096, 512, 512, 128, 19968),
    LDPCCode.TM6144: CodeParams(6144, 4096, 1024, 1024, 256, 23552),
    LDPCCode.TM8192: CodeParams(8192, 4096, 2048, 2048, 512, 30720),
}

ALL_CODES: tuple[LDPCCode, ...] = tuple(LDPCCode)
TC_CODES: tuple[LDPCCode, ...] = (LDPCCode.TC128, LDPCCode.TC256, LDPCCode.TC512)
TM_CODES: tuple[LDPCCode, ...] = tuple(c for c in LDPCCode if c.value.startswith("TM"))


@lru_cache(maxsize=None)
def get_code(name: "str | LDPCCode") -> LDPCCode:
    """Look up a code by name ('TC128', 'tm8192', ...) or pass through an enum."""
    if isinstance(name, LDPCCode):
        return name
    try:
        return LDPCCode(name.upper())
    except ValueError:
        raise ValueError(f"unknown LDPC code {name!r}; choose from {[c.value for c in LDPCCode]}") from None
