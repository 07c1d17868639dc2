"""The H100 launch table: every kernel's launch shape, pinned per code.

PyTorch counterpart of `labrador_ldpc_tpu/ops/routing.py`. There each row is
a TPU measurement (a layout, a batch tile, a lane-parts flag); none of that
carries over. Here a row holds, for each of the four CUDA kernels, the
launch shape its wrapper's `launch_config` computes for the code on an H100:

  * the layered min-sum kernel (`cuda_layered`, B1/B2) and the flooding
    min-sum kernel (`cuda_qc`, B3/B4), per dtype form (f32, bf16, i8, i16):
    threads a CTA, checks a thread and dynamic shared bytes (one CTA a
    codeword);
  * the layered sum-product kernel (`cuda_sp`, B7): the same, float32 only;
  * the bit-flip kernel (`cuda_bf`, B5/B6): threads a CTA, lanes a codeword,
    codewords a CTA and dynamic shared bytes.

The `launch_config` functions stay the one computation; `ROUTES` pins what
they give, and `tests/test_torch_sizes.py` holds the two equal. A code
without a row fails loudly in `route_for`, and every decoder factory of a
kernel calls it when it is built, so a new code or an edited prototype fails
before any launch instead of running a shape nobody checked on the card.

CTAs per SM are not in the table: they depend on the registers ptxas gives
each instance. `sizes.decoder_memory` reports them at the kernels' register
budget, and `chip_smoke.py` holds them to the card's occupancy calculator
at ptxas's registers.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

from ..codes.params import LDPCCode, get_code

__all__ = ["Check", "Forms", "Lanes", "KernelRoute", "ROUTES", "route_for"]


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


ROUTES: dict[str, KernelRoute] = {
    "TC128": KernelRoute(
        layered=Forms(Check(32, 1, 3112), Check(32, 1, 1576), Check(32, 1, 1192),
                      Check(32, 1, 1832)),
        flooding=Forms(Check(32, 1, 2048), Check(32, 1, 1536), Check(32, 1, 1280),
                       Check(32, 1, 1536)),
        sumproduct=Check(32, 1, 2560),
        bitflip=Lanes(256, 4, 64, 9528)),
    "TC256": KernelRoute(
        layered=Forms(Check(32, 1, 6192), Check(32, 1, 3120), Check(32, 1, 2352),
                      Check(32, 1, 3632)),
        flooding=Forms(Check(32, 1, 4096), Check(32, 1, 3072), Check(32, 1, 2560),
                       Check(32, 1, 3072)),
        sumproduct=Check(32, 1, 5120),
        bitflip=Lanes(256, 4, 64, 9528)),
    "TC512": KernelRoute(
        layered=Forms(Check(32, 2, 12384), Check(32, 2, 6240), Check(32, 2, 4704),
                      Check(32, 2, 7264)),
        flooding=Forms(Check(64, 1, 8192), Check(64, 1, 6144), Check(64, 1, 5120),
                       Check(64, 1, 6144)),
        sumproduct=Check(64, 1, 10240),
        bitflip=Lanes(256, 8, 32, 9784)),
    "TM1280": KernelRoute(
        layered=Forms(Check(128, 1, 28896), Check(64, 2, 14560), Check(32, 4, 11616),
                      Check(64, 2, 17376)),
        flooding=Forms(Check(128, 1, 21248), Check(128, 1, 15616), Check(128, 1, 12800),
                       Check(128, 1, 15616)),
        sumproduct=Check(128, 1, 25600),
        bitflip=Lanes(256, 16, 16, 13344)),
    "TM1536": KernelRoute(
        layered=Forms(Check(128, 2, 37184), Check(64, 4, 18752), Check(64, 4, 14912),
                      Check(64, 4, 22336)),
        flooding=Forms(Check(256, 1, 26112), Check(256, 1, 18944), Check(256, 1, 15360),
                       Check(256, 1, 18944)),
        sumproduct=Check(256, 1, 30720),
        bitflip=Lanes(256, 32, 8, 9456)),
    "TM2048": KernelRoute(
        layered=Forms(Check(256, 2, 53760), Check(128, 4, 27136), Check(128, 4, 21504),
                      Check(128, 4, 32256)),
        flooding=Forms(Check(256, 2, 35840), Check(256, 2, 25600), Check(256, 2, 20480),
                       Check(256, 2, 25600)),
        sumproduct=Check(256, 2, 40960),
        bitflip=Lanes(256, 32, 8, 13736)),
    "TM5120": KernelRoute(
        layered=Forms(Check(512, 1, 115584), Check(256, 2, 58240), Check(256, 2, 46464),
                      Check(256, 2, 69504)),
        flooding=Forms(Check(512, 1, 84992), Check(512, 1, 62464), Check(512, 1, 51200),
                       Check(512, 1, 62464)),
        sumproduct=Check(512, 1, 102400),
        bitflip=Lanes(256, 32, 8, 29120)),
    "TM6144": KernelRoute(
        layered=Forms(Check(1024, 1, 148736), Check(256, 4, 75008), Check(256, 4, 59648),
                      Check(512, 2, 89344)),
        flooding=Forms(Check(1024, 1, 104448), Check(1024, 1, 75776), Check(1024, 1, 61440),
                       Check(1024, 1, 75776)),
        sumproduct=Check(1024, 1, 122880),
        bitflip=Lanes(256, 32, 8, 37680)),
    "TM8192": KernelRoute(
        layered=Forms(Check(1024, 2, 215040), Check(512, 4, 108544), Check(512, 4, 86016),
                      Check(1024, 2, 129024)),
        flooding=Forms(Check(1024, 2, 143360), Check(1024, 2, 102400), Check(1024, 2, 81920),
                       Check(1024, 2, 102400)),
        sumproduct=Check(1024, 2, 163840),
        bitflip=Lanes(256, 32, 8, 54824)),
}


def route_for(code: LDPCCode | str) -> KernelRoute:
    """The pinned launch shapes of `code`. Fails loudly for a code without a
    row: compute its shapes with the four `launch_config` functions, check
    them on the card (`chip_smoke.py` phases 7, 8, 11, 12 and 15), and pin
    them in `ROUTES`; a route is never borrowed from another code."""
    name = get_code(code).value
    try:
        return ROUTES[name]
    except KeyError:
        raise KeyError(
            f"no H100 launch route for code {name!r}: compute its row with the launch_config "
            f"of ops/cuda_layered, cuda_qc, cuda_sp and cuda_bf, check it on the card "
            f"(chip_smoke.py), and pin it in ops/routing.ROUTES; a route is never borrowed "
            f"from another code"
        ) from None
