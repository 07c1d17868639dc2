"""The H100 launch table: every kernel's launch shape for a code.

PyTorch counterpart of `labrador_ldpc_tpu/ops/routing.py`. There each row is
a TPU measurement (a layout, a batch tile, a lane-parts flag); none of that
carries over. Here a code's route holds, for each of the four CUDA kernels,
the launch shape its wrapper's `launch_config` computes from the code and
the H100's limits (`card`):

  * the layered min-sum kernel (`cuda_layered`, B1/B2) and the flooding
    min-sum kernel (`cuda_qc`, B3/B4), per dtype form (f32, bf16, i8, i16):
    threads a CTA, checks a thread and dynamic shared bytes (one CTA a
    codeword);
  * the layered sum-product kernel (`cuda_sp`, B7): the same, float32 only;
  * the bit-flip kernel (`cuda_bf`, B5/B6): threads a CTA, lanes a codeword,
    codewords a CTA and dynamic shared bytes.

`tests/test_torch_sizes.py` pins every code's route, so a change of any
shape fails there until its expected row is updated; `chip_smoke.py` phase
15 checks the routes on the card.

CTAs per SM are not in the route: they depend on the registers ptxas gives
each instance. `sizes.decoder_memory` reports them at the kernels' register
budget, and `chip_smoke.py` holds them to the card's occupancy calculator
at ptxas's registers.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import NamedTuple

from ..codes.params import LDPCCode, get_code
from . import cuda_bf, cuda_layered, cuda_qc, cuda_sp
from .cuda_layered import FORMS

__all__ = ["Check", "Forms", "Lanes", "KernelRoute", "route_for"]


class Check(NamedTuple):
    """Launch shape of a kernel with one CTA a codeword and one owner thread
    a check (B1-B4, B7)."""

    threads: int
    checks_per_thread: int
    smem_bytes: int


class Lanes(NamedTuple):
    """Launch shape of the bit-flip kernel: a lane group of a warp a
    codeword (B5/B6)."""

    threads: int
    lanes: int
    codewords_per_cta: int
    smem_bytes: int


class Forms(NamedTuple):
    """A min-sum kernel's launch shape in each dtype form
    (`cuda_layered.FORMS`)."""

    f32: Check
    bf16: Check
    i8: Check
    i16: Check


@dataclass(frozen=True)
class KernelRoute:
    """The launch shapes of one code's four kernels on an H100."""

    layered: Forms
    flooding: Forms
    sumproduct: Check
    bitflip: Lanes


def _check(cfg: dict) -> Check:
    return Check(cfg["threads"], cfg["checks_per_thread"], cfg["smem_bytes"])


@lru_cache(maxsize=None)
def route_for(code: LDPCCode | str) -> KernelRoute:
    """The launch shapes of `code`'s four kernels, from their wrappers'
    `launch_config`, computed once per argument. Raises the ValueError of a
    kernel that cannot take the code."""
    code = get_code(code)

    def forms(mod) -> Forms:
        return Forms(**{form: _check(mod.launch_config(code, dt)) for dt, form in FORMS.items()})

    bf = cuda_bf.launch_config(code)
    return KernelRoute(
        layered=forms(cuda_layered), flooding=forms(cuda_qc),
        sumproduct=_check(cuda_sp.launch_config(code)),
        bitflip=Lanes(bf["threads"], bf["lanes"], bf["codewords_per_cta"], bf["smem_bytes"]))
