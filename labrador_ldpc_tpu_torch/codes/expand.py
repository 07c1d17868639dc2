"""Expansion of the compact CCSDS code descriptions into dense device tables.

The port's own copy of `labrador_ldpc_tpu/codes/expand.py` (numpy only; the
port never imports the JAX package). tests/test_torch_codes.py pins every
table here equal to the JAX package's for all nine codes.

The reference crate never materializes H or G: it re-derives every parity
edge lazily from the prototype constants (ParityIter, src/codes/mod.rs:243-363)
and re-rotates the compact generator rows on the fly (src/encoder.rs:190-252),
because flash/RAM are scarce on its embedded targets. On an accelerator the
opposite tradeoff holds: we expand everything ONCE in Python/NumPy into

  * the full parity-edge list in the reference's deterministic iteration
    order (used as the semantic oracle and to build the decoder tables),
  * dense per-degree gather tables for the message-passing decoders
    (check-major edge grid + variable-side index tables), and
  * the dense (k, n-k) GF(2) generator parity block for the matmul encoder.

Expansion math ported from the reference (the *recipe*, not the code):
  * HI blocks: var = colidx*M + ((check + shift) mod M)      (codes/mod.rs:305-311)
  * HP blocks: pi_k(i) = (M/4)*((theta_k + floor(4i/M)) mod 4)
               + (phi_k(floor(4i/M), M) + i) mod (M/4)       (codes/mod.rs:312-322,
                                                   compact_parity_checks.rs:107-108)
  * three prototype planes concatenated in plane order; a cell chain stops at
    the first zero byte, and duplicate (check,var) pairs — if the planes ever
    produced them — would remain distinct edges, exactly as the reference
    iterator yields them (codes/mod.rs:295-362).
  * full G row (crow*b + o) = compact row crow right-rotated by o within each
    b-bit block (equivalent to the XOR-then-left-rotate loop of
    encoder.rs:203-245).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np

from . import constants as C
from ._generator_data import COMPACT_GENERATORS
from .params import LDPCCode, get_code

__all__ = [
    "parity_edges",
    "parity_check_matrix",
    "generator_parity_matrix",
    "DecoderTables",
    "decoder_tables",
    "BlockPerm",
    "QCStructure",
    "qc_structure",
]


def _prototype_for(code: LDPCCode) -> tuple[np.ndarray, np.ndarray | None]:
    """Return (prototype planes, phi table or None) for a code."""
    if code.value.startswith("TC"):
        return C.TC_PROTOTYPES[code.value], None
    m = code.submatrix_size
    cols = (code.n + code.punctured_bits) // m
    return C.TM_PROTOTYPES_BY_COLS[cols], C.PHI_J_K[m]


@lru_cache(maxsize=None)
def parity_edges(code: LDPCCode | str) -> np.ndarray:
    """All (check, var) edges of H, in the reference's iteration order.

    Returns an int64 array of shape (paritycheck_sum, 2). The order is
    (prototype row, prototype col, plane, in-block row), matching
    ParityIter (codes/mod.rs:294-362) so that downstream tables can
    reproduce the reference's floating-point accumulation order exactly.
    """
    code = get_code(code)
    proto, phi = _prototype_for(code)
    m = code.submatrix_size
    i = np.arange(m, dtype=np.int64)

    chunks: list[np.ndarray] = []
    for rowidx in range(proto.shape[1]):
        for colidx in range(proto.shape[2]):
            for plane in range(proto.shape[0]):
                cell = int(proto[plane, rowidx, colidx])
                if cell == 0:
                    # zero byte terminates the plane chain for this cell
                    # (codes/mod.rs:332-338); later planes are never nonzero
                    # when an earlier one is zero in the CCSDS tables.
                    break
                kind = cell & C.SUBMAT_KIND_MASK
                val = cell & C.SUBMAT_VAL_MASK
                if kind == C.HI:
                    var_in_block = (i + val) & (m - 1)
                elif kind == C.HP:
                    assert phi is not None, "HP blocks only occur in TM codes"
                    j = i >> (m // 4).bit_length() - 1  # floor(i / (M/4)) == floor(4i/M)
                    pi = ((C.THETA_K[val] + j) % 4) * (m // 4) + ((phi[j, val] + i) & (m // 4 - 1))
                    var_in_block = pi
                else:  # HZ with nonzero byte cannot occur; kind==0 means HZ handled above
                    continue
                chk = rowidx * m + i
                var = colidx * m + var_in_block
                chunks.append(np.stack([chk, var], axis=1))
    edges = np.concatenate(chunks, axis=0)
    assert edges.shape[0] == code.paritycheck_sum, (
        f"{code}: expanded {edges.shape[0]} edges, expected {code.paritycheck_sum}"
    )
    return edges


@lru_cache(maxsize=None)
def parity_check_matrix(code: LDPCCode | str) -> np.ndarray:
    """Dense mod-2 H of shape (n+p-k, n+p), uint8.

    Duplicate edges cancel (sum mod 2), matching the reference's
    plane-summation semantics (compact_parity_checks.rs:100-105).
    """
    code = get_code(code)
    p = code.params
    h = np.zeros((p.n_checks, p.n_vars), dtype=np.uint8)
    e = parity_edges(code)
    np.add.at(h, (e[:, 0], e[:, 1]), 1)
    return (h & 1).astype(np.uint8)


@lru_cache(maxsize=None)
def generator_parity_matrix(code: LDPCCode | str) -> np.ndarray:
    """Dense parity block of the systematic generator: shape (k, n-k), uint8.

    Row (crow*b + o) is compact row crow right-rotated by o within each
    consecutive b-bit block, b = circulant_size (encoder.rs:203-245,
    codes/mod.rs:11-19). Bits are unpacked MSB-first from the u64 constants.
    """
    code = get_code(code)
    p = code.params
    k, r, b = p.k, p.n - p.k, p.circulant_size
    packed = np.array(COMPACT_GENERATORS[code.value], dtype=np.uint64)
    rows = k // b
    row_len = r // 64
    assert packed.size == rows * row_len
    # unpack to bits, MSB-first within each u64 (encoder.rs:59-68)
    bits = np.unpackbits(packed.reshape(rows, row_len).view(np.uint8), axis=1, bitorder="big")
    # u64 stored little-endian in memory -> byte order within each u64 must be
    # reversed to get MSB-first bit significance across the word.
    bits = (
        bits.reshape(rows, row_len, 8, 8)[:, :, ::-1, :].reshape(rows, r)
    )
    # expand circulants: G[crow*b + o, blk*b + j] = compact[crow, blk*b + ((j - o) % b)]
    g = np.zeros((k, r), dtype=np.uint8)
    nblocks = r // b
    compact_blocks = bits.reshape(rows, nblocks, b)
    for o in range(b):
        g[o::b, :] = np.roll(compact_blocks, o, axis=2).reshape(rows, r)
    return g


@dataclass(frozen=True)
class DecoderTables:
    """Static gather/scatter tables driving the message-passing decoders.

    Edge storage layout is a dense check-major grid of shape (C, dc_max):
    row c holds check c's edges (padded), so check-node reductions are plain
    masked axis reductions, and variable-node accumulation is a row gather via
    `var_edge_idx` into the flattened grid (one extra sentinel slot at index
    C*dc_max holds the neutral element). This is the TPU-native replacement
    for the reference's lazy ParityIter + flat working arrays
    (decoder.rs:374-378).
    """

    code: LDPCCode
    n_checks: int  # C = n + p - k
    n_vars: int  # V = n + p
    n_edges: int  # |E| = paritycheck_sum
    dc_max: int
    dv_max: int
    # (C, dc_max): var index of each check-edge; pad slots hold V (sentinel)
    check_nbrs: np.ndarray
    # (C, dc_max): bool validity
    check_mask: np.ndarray
    # (V, dv_max): flat index into the (C*dc_max + 1)-slot edge grid, in the
    # reference's per-variable edge order; pad slots hold C*dc_max (sentinel)
    var_edge_idx: np.ndarray
    # (V, dv_max): check index of each var-edge; pad slots hold C (sentinel)
    var_check_idx: np.ndarray
    # (V, dv_max): bool validity
    var_mask: np.ndarray
    # (E,): for each reference-order edge, its flat grid slot (tests/oracle)
    ref_edge_slot: np.ndarray
    # (V,): variable degree
    var_degree: np.ndarray


@lru_cache(maxsize=None)
def decoder_tables(code: LDPCCode | str) -> DecoderTables:
    code = get_code(code)
    p = code.params
    edges = parity_edges(code)  # reference order
    Cn, Vn, E = p.n_checks, p.n_vars, p.paritycheck_sum

    chk = edges[:, 0]
    var = edges[:, 1]
    # check-major grid: stable sort by check preserves reference order within
    # each check (irrelevant for semantics, kept for determinism).
    order = np.argsort(chk, kind="stable")
    deg_c = np.bincount(chk, minlength=Cn)
    dc_max = int(deg_c.max())
    check_nbrs = np.full((Cn, dc_max), Vn, dtype=np.int32)
    check_mask = np.zeros((Cn, dc_max), dtype=bool)
    slot_within = np.zeros(E, dtype=np.int64)
    # position of each (reference-order) edge within its check row
    counts = np.zeros(Cn, dtype=np.int64)
    for e in order:
        c = chk[e]
        j = counts[c]
        counts[c] += 1
        check_nbrs[c, j] = var[e]
        check_mask[c, j] = True
        slot_within[e] = j
    ref_edge_slot = (chk * dc_max + slot_within).astype(np.int32)

    deg_v = np.bincount(var, minlength=Vn)
    dv_max = int(deg_v.max())
    sentinel_slot = Cn * dc_max
    var_edge_idx = np.full((Vn, dv_max), sentinel_slot, dtype=np.int32)
    var_check_idx = np.full((Vn, dv_max), Cn, dtype=np.int32)
    var_mask = np.zeros((Vn, dv_max), dtype=bool)
    vcounts = np.zeros(Vn, dtype=np.int64)
    # iterate in reference order so per-variable accumulation order matches
    # the reference's sweep order exactly (decoder.rs:388-411)
    for e in range(E):
        v = var[e]
        j = vcounts[v]
        vcounts[v] += 1
        var_edge_idx[v, j] = ref_edge_slot[e]
        var_check_idx[v, j] = chk[e]
        var_mask[v, j] = True

    return DecoderTables(
        code=code,
        n_checks=Cn,
        n_vars=Vn,
        n_edges=E,
        dc_max=dc_max,
        dv_max=dv_max,
        check_nbrs=check_nbrs,
        check_mask=check_mask,
        var_edge_idx=var_edge_idx,
        var_check_idx=var_check_idx,
        var_mask=var_mask,
        ref_edge_slot=ref_edge_slot,
        var_degree=deg_v.astype(np.int32),
    )


# --- QC (protograph) block structure -----------------------------------------
#
# Every nonzero prototype cell of the CCSDS codes is a PERMUTATION submatrix:
# HI|s is the identity right-shifted by s, and HP|K is the Pi_K permutation,
# which decomposes into a rotation of the four M/4-quarters by theta_K plus a
# circular shift of each quarter by phi(j, K) (compact_parity_checks.rs:107-108).
# So the entire H is a (R x Cc) grid of M x M permutations (several addends may
# share a cell: plane sums). So message gathers/scatters in the decoders
# reduce to `roll`s along the node axis (ops/qc_minsum.py) or, in the CUDA
# kernel, to one small per-addend table (ops/cuda_layered.py).


@dataclass(frozen=True)
class BlockPerm:
    """One addend: an M x M permutation linking check block `row` to var
    block `col`. Edge (row*M + i, col*M + perm(i)) exists for all i.

    kind == "rot":  perm(i) = (i + shift) mod M            (HI | shift)
    kind == "pi":   perm(i) = (M/4)*((theta + j) mod 4)
                              + (phis[j] + i) mod (M/4),
                    j = floor(i / (M/4))                    (HP | K)
    """

    row: int
    col: int
    kind: str  # "rot" | "pi"
    shift: int = 0
    theta: int = 0
    phis: tuple = ()

    def apply(self, i: np.ndarray, m: int) -> np.ndarray:
        """perm(i) as numpy (for tests/oracles)."""
        if self.kind == "rot":
            return (i + self.shift) % m
        q = m // 4
        j = i // q
        phi = np.asarray(self.phis)[j]
        return ((self.theta + j) % 4) * q + (phi + i) % q


@dataclass(frozen=True)
class QCStructure:
    code: LDPCCode
    m: int  # submatrix size M
    n_block_rows: int  # R  = (n + p - k) / M
    n_block_cols: int  # Cc = (n + p) / M
    # addends grouped by prototype row, in the reference plane-scan order
    rows: tuple  # tuple[tuple[BlockPerm, ...], ...]


@lru_cache(maxsize=None)
def qc_structure(code: LDPCCode | str) -> QCStructure:
    code = get_code(code)
    p = code.params
    proto, phi = _prototype_for(code)
    m = code.submatrix_size
    R, Cc = p.n_checks // m, p.n_vars // m
    rows = []
    for rowidx in range(R):
        addends = []
        for colidx in range(proto.shape[2]):
            for plane in range(proto.shape[0]):
                cell = int(proto[plane, rowidx, colidx])
                if cell == 0:
                    break  # plane chain ends (codes/mod.rs:332-338)
                kind = cell & C.SUBMAT_KIND_MASK
                val = cell & C.SUBMAT_VAL_MASK
                if kind == C.HI:
                    addends.append(BlockPerm(rowidx, colidx, "rot", shift=val))
                elif kind == C.HP:
                    addends.append(
                        BlockPerm(
                            rowidx,
                            colidx,
                            "pi",
                            theta=int(C.THETA_K[val]),
                            phis=tuple(int(phi[j, val]) for j in range(4)),
                        )
                    )
        rows.append(tuple(addends))
    s = QCStructure(code=code, m=m, n_block_rows=R, n_block_cols=Cc, rows=tuple(rows))
    assert sum(len(r) for r in s.rows) * m == p.paritycheck_sum
    return s
