"""The yardstick of the roofline metrics: published peaks and the work each
layer's algorithm defines.

The counts are the algorithms', frozen here, and not those of today's
kernel sources: whatever implements the work, its roofline share reads the
same work. A share is the least time the card could take (the larger of
operations over the operation peak and bytes over the bandwidth) over the
device time measured; it cannot pass 100 % unless the work is overcounted
or the time misses part of it.

Peaks of one NVIDIA H100 SXM (data sheet, dense, at its 700 W limit):
3.35 TB/s HBM3; 67 T operations/s on the CUDA cores (float32 and int32
alike, outside the tensor cores); 1,979 T operations/s int8 on the tensor
cores. The harness prints the card's power limit beside every share.

  * Layered min-sum: 20 operations per edge and sweep in float32, 23 in the
    saturating int8 form (three clips). Sweeps are those the inputs
    needed: iterations + 1 for a codeword that converged (0-based
    iteration), maxiters for one that did not. Bytes: the LLRs read once,
    the outputs (bits, success, iterations) written once.
  * Bit-flip: per edge and iteration the parity XOR and the violation
    count, per variable and iteration the vote and the flip, each a bit
    operation, 32 to one 32-bit operation. Iterations as for min-sum, plus
    the erasure pass of a punctured code. Bytes: the hard decisions read
    once, the outputs written once.
  * Encoder: 2 k (n - k) operations a codeword, the exact 0/1 product that
    the int8 tensor cores can run with int32 accumulation, against their
    peak. Bytes: the (B, k) data bits in, the (B, n) codeword bits out.
"""

from __future__ import annotations

__all__ = ["HBM_BYTES_S", "CORE_OPS_S", "INT8_TC_OPS_S", "LAYERED_OPS", "bound_s", "layered",
           "bitflip", "encoder", "share_pct"]

HBM_BYTES_S = 3.35e12
CORE_OPS_S = 67e12
INT8_TC_OPS_S = 1979e12
LAYERED_OPS = {"float32": 20, "int8": 23}  # per edge and sweep
OUTPUT_BYTES = 1 + 4  # success (bool) and iterations (int32) a codeword, besides its bits


def bound_s(ops: float, ops_s: float, nbytes: float) -> tuple[float, str]:
    """(least seconds, "ops" or "bytes": which bounds it)."""
    t_ops, t_bytes = ops / ops_s, nbytes / HBM_BYTES_S
    return (t_ops, "ops") if t_ops >= t_bytes else (t_bytes, "bytes")


def layered(edges: int, n: int, n_vars: int, frames: int, sweeps: int,
            dtype: str) -> tuple[float, str]:
    llr_bytes = 4 if dtype == "float32" else 1
    ops = LAYERED_OPS[dtype] * edges * sweeps
    nbytes = frames * (n * llr_bytes + n_vars + OUTPUT_BYTES)
    return bound_s(ops, CORE_OPS_S, nbytes)


def bitflip(edges: int, n: int, n_vars: int, frames: int, iterations: int) -> tuple[float, str]:
    ops = (2 * edges + 2 * n_vars) * iterations / 32
    nbytes = frames * (n + n_vars + OUTPUT_BYTES)
    return bound_s(ops, CORE_OPS_S, nbytes)


def encoder(k: int, n: int, codewords: int) -> tuple[float, str]:
    return bound_s(2 * k * (n - k) * codewords, INT8_TC_OPS_S, codewords * (k + n))


def share_pct(bound: float, measured_s: float) -> float | None:
    """100 * bound / measured, or None where nothing was measured."""
    if measured_s <= 0:
        return None
    return 100.0 * bound / measured_s
