"""The yardstick of the sum-product roofline metric: the work the row-layered
belief propagation of `reference/sumproduct.py` defines, frozen beside
`roofline.py` and against its peaks.

Operations, 28 an edge and sweep, counted on the algorithm and not on
today's kernel source:
  * pass 1, 13: the subtraction t = perm(va) - u_old, |t|, phi (8), the
    sign compare t < 0, the phi-sum add, the sign xor;
  * pass 2, 13: phi_sum - ph, phi (8), the sign xor, the negating select,
    u - u_old, the posterior add;
  * the syndrome, 2: the sign compare and the parity xor;
  * phi, 8: the clamp (2: max and min), the negation, exp, 1 + e, 1 - e, the
    IEEE division and log, each one operation.
exp, log and the division each take many instructions on the CUDA cores, so
the bound is a lower bound on the time, and the share a generous one.

Sweeps are those the inputs needed: iterations + 1 for a codeword that
converged (0-based iteration), maxiters for one that did not. Bytes: the
float32 LLRs read once (4 n a frame), the bits (n_vars), the success flag
(1) and the iterations (4) written once.
"""

from __future__ import annotations

from .roofline import CORE_OPS_S, bound_s

__all__ = ["SP_OPS", "sumproduct"]

SP_OPS = 13 + 13 + 2  # per edge and sweep
OUTPUT_BYTES = 1 + 4  # success (bool) and iterations (int32) a codeword, besides its bits


def sumproduct(edges: int, n: int, n_vars: int, frames: int, sweeps: int) -> tuple[float, str]:
    """(least seconds, "ops" or "bytes") of `frames` codewords decoded in
    `sweeps` codeword-sweeps in all."""
    return bound_s(SP_OPS * edges * sweeps, CORE_OPS_S, frames * (4 * n + n_vars + OUTPUT_BYTES))
