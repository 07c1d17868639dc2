"""The reference's encoder, channels, draws and waterfall bookkeeping.

  * `encode`: (B, k) data bits -> (B, n) codeword bits, the GF(2) product
    with the generator's parity block as a 0/1 float32 product with TF32
    off (every partial sum is an integer below 2^24, so it is exact), then
    mod 2. `product` selects a lower precision for the controls.
  * `pack`: bits -> MSB-first bytes.
  * `draw`: one waterfall batch's random inputs from its generator, in the
    order the program's trial step draws them (data bits, then the noise):
    the benchmark's copy of the program's stated seeding rule, so that the
    reference sees the same trials.
  * `batch_generator`: the generator of batch `index` of a sweep seeded by
    `seed`: numpy's SeedSequence([seed, index]) -> one uint64 -> a
    torch.Generator on the device.
  * `replay_point`: one waterfall point recomputed batch by batch, with the
    stopping rule (a bits budget fixed ahead of launch, a bit-error budget
    read as batches drain, `depth` batches in flight that all count).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Callable

import numpy as np
import torch

from .codes import code, generator_parity
from .decoders import bitflip, layered_minsum

__all__ = ["encode", "pack", "batch_generator", "draw", "ebn0_sigma", "perftest_sigma",
           "Counters", "replay_point", "trial_counters"]


@lru_cache(maxsize=None)
def _g(name: str, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(generator_parity(name), device=device).to(torch.float32)


def encode(name: str, data_bits: torch.Tensor, product: str = "float32") -> torch.Tensor:
    """`product`: "float32" (TF32 off, exact), "tf32" (TF32 on), "bfloat16"
    (operands and result in bfloat16: sums above 256 round)."""
    g = _g(name, data_bits.device)
    x = data_bits.to(torch.float32)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = product == "tf32"
    try:
        if product == "bfloat16":
            parity = torch.matmul(x.to(torch.bfloat16), g.to(torch.bfloat16)).to(torch.float32)
        else:
            parity = torch.matmul(x, g)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    parity = parity.to(torch.int32).bitwise_and(1).to(torch.uint8)
    return torch.cat([data_bits.to(torch.uint8), parity], dim=1)


def pack(bits: torch.Tensor) -> torch.Tensor:
    b = bits.to(torch.uint8).reshape(*bits.shape[:-1], bits.shape[-1] // 8, 8)
    w = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.int32, device=bits.device)
    return (b.to(torch.int32) * w).sum(dim=-1).to(torch.uint8)


def ebn0_sigma(ebn0_db: float, rate: float) -> float:
    """BPSK over AWGN at Eb/N0: sigma^2 = 1 / (2 R 10^(dB/10))."""
    return float((2.0 * rate * 10.0 ** (ebn0_db / 10.0)) ** -0.5)


def perftest_sigma(snr_db: float) -> float:
    """The upstream perftest's convention (perftest/src/main.rs:15)."""
    return float(10.0 ** (-snr_db / 10.0))


def batch_generator(seed: int, index: int, device: torch.device) -> torch.Generator:
    state = np.random.SeedSequence([seed, index]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def draw(gen: torch.Generator, batch: int, k: int, n: int, noise: str, param: float,
         device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    data = torch.randint(0, 2, (batch, k), generator=gen, device=device, dtype=torch.uint8)
    if noise == "bsc":
        return data, torch.rand((batch, n), generator=gen, device=device) < param
    return data, torch.randn((batch, n), generator=gen, device=device)


def bpsk_awgn(cw_bits: torch.Tensor, noise: torch.Tensor, sigma: float) -> torch.Tensor:
    """1 - 2c + sigma * noise in float32: the product rounded, then the sum."""
    s = torch.tensor(sigma, dtype=torch.float32, device=cw_bits.device)
    return (1.0 - 2.0 * cw_bits.to(torch.float32)) + noise.to(torch.float32) * s


@dataclass
class Counters:
    trials: int = 0
    bit_errors: int = 0
    frame_errors: int = 0
    decode_failures: int = 0
    iterations: int = 0

    def add(self, other: "Counters") -> None:
        for f in self.__dataclass_fields__:
            setattr(self, f, getattr(self, f) + getattr(other, f))


def trial_counters(name: str, data: torch.Tensor, noise: torch.Tensor, param: float,
                   decoder: str, noise_model: str, maxiters: int,
                   product: str = "float32") -> Counters:
    """One batch: encode -> channel -> decode -> counters."""
    c = code(name)
    cw = encode(name, data, product)
    if decoder == "bf":
        if noise_model != "bsc":
            raise ValueError("the reference's bit-flip trials take the bsc channel")
        res = bitflip(c, cw ^ noise.to(torch.uint8), maxiters)
    else:
        res = layered_minsum(c, bpsk_awgn(cw, noise, param), maxiters)
    err = (res.bits[:, :c.k] != data).sum(dim=1)
    return Counters(data.shape[0], int(err.sum()), int((err > 0).sum()),
                    int((~res.success).sum()), int(res.iterations.sum()))


def replay_point(batch_counters: Callable[[int], Counters], first_batch: int, batch: int, k: int,
                 max_bits: int, max_bit_errors: int, depth: int) -> tuple[Counters, int]:
    """A point's counters under the stopping rule; `batch_counters(i)` gives
    sweep batch i's. Returns (counters, batches used)."""
    n_max = max(1, -(-max_bits // (batch * k)))
    total = Counters()
    launched, inflight, index = 0, [], first_batch
    while True:
        while launched < n_max and len(inflight) < max(1, depth) and \
                total.bit_errors < max_bit_errors:
            inflight.append(index)
            index += 1
            launched += 1
        if not inflight:
            return total, launched
        total.add(batch_counters(inflight.pop(0)))
