"""The H100 (sm_90) that the port's kernels are sized for: its published
limits, the occupancy rule, and the SM count.

Every CUDA wrapper's `launch_config` computes its kernel's launch shape from
these, in plain Python with no card: `fit_shared` refuses a CTA over the
shared memory one CTA can address, and `ctas_per_sm` counts the CTAs of a
shape that fit on one SM, as the CUDA runtime's occupancy calculator does
(`chip_smoke.py` holds the two equal at ptxas's registers on the card).
`sms` reads the SM count of a card; `H100_SMS` stands for it in the tables
made with no card (`sizes`).
"""

from __future__ import annotations

from functools import lru_cache

import torch

from ..codes.params import LDPCCode

__all__ = ["SM_SHARED_BYTES", "CTA_RESERVED_BYTES", "CTA_SHARED_MAX", "MAX_CTAS_PER_SM",
           "MAX_WARPS_PER_SM", "SUB_PARTITION_REGISTERS", "SUB_PARTITIONS", "REGISTER_UNIT",
           "REGISTERS_PER_THREAD", "H100_SMS", "warps_per_sm", "ctas_per_sm", "fit_shared", "sms"]

# shared memory: an SM's 228 KiB, the runtime's 1 KiB reserved per resident
# CTA, and the 227 KiB one CTA can address
SM_SHARED_BYTES = 233_472
CTA_RESERVED_BYTES = 1_024
CTA_SHARED_MAX = 232_448
MAX_CTAS_PER_SM = 32
MAX_WARPS_PER_SM = 64
# an SM's registers come in four sub-partitions; a warp takes whole units of
# 256 registers from one of them
SUB_PARTITION_REGISTERS = 16_384
SUB_PARTITIONS = 4
REGISTER_UNIT = 256
# a thread's share of the 65,536 in a CTA of 1,024 threads: the budget of
# __launch_bounds__(1024), to which the decoder kernels are sized
REGISTERS_PER_THREAD = 64
H100_SMS = 132  # SMs of one H100 SXM


def warps_per_sm(registers: int) -> int:
    """The warps one SM runs when a thread takes `registers` registers: the
    fewer of what the register file holds and 64."""
    per_warp = -(-registers * 32 // REGISTER_UNIT) * REGISTER_UNIT
    return min(MAX_WARPS_PER_SM, SUB_PARTITION_REGISTERS // per_warp * SUB_PARTITIONS)


def ctas_per_sm(smem: int, threads: int, registers: int) -> int:
    """The CTAs of `threads` threads, `smem` dynamic shared bytes and
    `registers` registers a thread that fit on one SM: the fewest that
    shared memory, the register file, 64 warps and 32 CTAs allow."""
    return min(MAX_CTAS_PER_SM, SM_SHARED_BYTES // (smem + CTA_RESERVED_BYTES),
               warps_per_sm(registers) // (threads // 32))


def fit_shared(code: LDPCCode, smem: int) -> None:
    """Raise a ValueError if a CTA of `code`'s kernel needs more than the
    `CTA_SHARED_MAX` shared bytes one CTA can address."""
    if smem > CTA_SHARED_MAX:
        raise ValueError(f"{code} needs {smem} B of shared memory, over {CTA_SHARED_MAX}")


@lru_cache(maxsize=None)
def sms(device: torch.device | int) -> int:
    """The SMs of a CUDA card, read once."""
    return torch.cuda.get_device_properties(device).multi_processor_count
