"""The benchmark's two codes, expanded from the frozen tables alone.

`code(name)` gives a `Code`: its sizes, its parity-check matrix as rows of
M x M block permutations (every nonzero prototype cell of a CCSDS code is a
permutation, so H is a grid of them), and the dense (k, n-k) parity block
of its systematic generator. The expansion rules are those of the CCSDS
recommendations as the upstream crate states them (src/codes/mod.rs:
ParityIter, compact_parity_checks.rs:107-108; encoder.rs:190-252):

  * HI | s:  check i of the block row meets variable (i + s) mod M;
  * HP | K:  variable (M/4)*((theta_K + j) mod 4) + (phi_K(j) + i) mod (M/4),
             j = floor(4i/M);
  * generator row crow*b + o is compact row crow right-rotated by o within
    each b-bit block (b the circulant size), bits MSB-first in each u64.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np

from . import tables as T

__all__ = ["Addend", "Code", "code", "CODES"]


@dataclass(frozen=True)
class Addend:
    """One M x M permutation between check block `row` and variable block
    `col`: edge (row*M + i, col*M + perm(i)) for every i."""

    row: int
    col: int
    kind: str  # "rot" | "pi"
    shift: int = 0
    theta: int = 0
    phis: tuple = ()


@dataclass(frozen=True)
class Code:
    name: str
    n: int  # transmitted bits
    k: int  # data bits
    punctured: int  # parity bits never transmitted
    m: int  # block size M
    circulant: int  # generator circulant size b
    rows: tuple  # tuple[tuple[Addend, ...], ...], one tuple a block row, in plane-scan order

    @property
    def n_vars(self) -> int:
        return self.n + self.punctured

    @property
    def n_checks(self) -> int:
        return self.n + self.punctured - self.k

    @property
    def n_block_cols(self) -> int:
        return self.n_vars // self.m

    @property
    def edges(self) -> int:
        return sum(len(r) for r in self.rows) * self.m


# name: (n, k, punctured, M, circulant, prototype, phi table or None, compact generator)
CODES = {
    "TC512": (512, 256, 0, 64, 64, T.TC512_H, None, T.TC512_G),
    "TM8192": (8192, 4096, 2048, 2048, 512, T.TM_R12_H, T.PHI_2048, T.TM8192_G),
}


@lru_cache(maxsize=None)
def code(name: str) -> Code:
    if name not in CODES:
        raise ValueError(f"the reference holds {sorted(CODES)}, not {name!r}")
    n, k, p, m, b, proto, phi, _ = CODES[name]
    n_rows = (n + p - k) // m
    rows = []
    for r in range(n_rows):
        addends = []
        for c in range(proto.shape[2]):
            for plane in range(proto.shape[0]):
                cell = int(proto[plane, r, c])
                if cell == 0:
                    break
                kind, val = cell & T.KIND_MASK, cell & T.VAL_MASK
                if kind == T.HI:
                    addends.append(Addend(r, c, "rot", shift=val))
                elif kind == T.HP:
                    addends.append(Addend(r, c, "pi", theta=int(T.THETA_K[val]),
                                          phis=tuple(int(phi[j, val]) for j in range(4))))
        rows.append(tuple(addends))
    return Code(name, n, k, p, m, b, tuple(rows))


@lru_cache(maxsize=None)
def generator_parity(name: str) -> np.ndarray:
    """The (k, n-k) uint8 parity block of the systematic generator."""
    c = code(name)
    k, r, b = c.k, c.n - c.k, c.circulant
    words = np.array(CODES[name][7], dtype=np.uint64)
    n_rows, row_words = k // b, r // 64
    # MSB-first bits of each u64: big-endian bytes, then big-endian bits
    compact = np.unpackbits(words.reshape(n_rows, row_words).astype(">u8").view(np.uint8),
                            axis=1, bitorder="big").reshape(n_rows, r // b, b)
    g = np.empty((k, r), dtype=np.uint8)
    for o in range(b):
        g[o::b] = np.roll(compact, o, axis=2).reshape(n_rows, r)
    return g
