"""Decoder registry, AWGN noise conventions and the soft trial step.

PyTorch counterpart of `labrador_ldpc_tpu/channel/awgn.py` for the
implementations this port has so far: "layered" (plain PyTorch) and
"cuda_layered" (the hand-written CUDA kernel), float32. Every other impl or
dtype raises a ValueError that names the queue item still to come, instead of
failing deep inside a decoder.

Two noise models (as the JAX package):
  * "perftest": the reference's convention — noise sigma = 10^(-snr/10)
    added directly to +-1 LLRs (perftest/src/main.rs:15; min-sum is
    scale-invariant, decoder.rs:332-335, so the LLRs stay unscaled);
  * "ebn0": BPSK over AWGN at Eb/N0 dB — sigma^2 = 1/(2 R 10^(x/10)).

A trial step draws its data and noise from an explicit `torch.Generator`
(`TrialStep.draw`) and hands them to a pure function (`TrialStep.apply`):
data -> encode -> channel -> decode -> counters. `torch.Generator` does not
reproduce `jax.random`, so the tests feed `apply` numpy-made data and noise
on both sides.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple

import torch

from ..codes.params import LDPCCode, get_code
from ..device import resolve_device
from ..ops.encoder import encode_bits

__all__ = ["ChannelStats", "TrialStep", "make_trial_step", "noise_sigma", "resolve_impl"]

IMPLS = ("auto", "layered", "cuda_layered")

# implementations of the JAX package that this port does not have yet
_LATER = {
    "ref": "the reference-order decoder comes with ROADMAP Queue A7",
    "qc": "flooding min-sum comes with ROADMAP Queue A7 (kernels B3/B4)",
    "qc_i8": "the saturating int flooding path comes with ROADMAP Queue A7",
    "qc_i16": "the saturating int flooding path comes with ROADMAP Queue A7",
    "pallas_qc": "the flooding kernel comes with ROADMAP Queue B3/B4",
    "pallas_layered": "is the TPU kernel; its CUDA port is impl='cuda_layered'",
    "sp": "sum-product comes with ROADMAP Queue A9",
    "sp_layered": "layered sum-product comes with ROADMAP Queue A9 (kernel B7)",
    "sp_pallas": "the sum-product kernel comes with ROADMAP Queue B7",
}


def _check_dtype(dtype: torch.dtype) -> None:
    if dtype == torch.float32:
        return
    if dtype in (torch.bfloat16, torch.int8, torch.int16):
        raise ValueError(
            f"{dtype} LLRs come with the main-path dtype slice (ROADMAP Queue A5); "
            "this port decodes float32"
        )
    if dtype in (torch.int32, torch.float64):
        raise ValueError(
            f"{dtype} LLRs need the reference-order decoder (ROADMAP Queue A7); "
            "this port decodes float32"
        )
    raise ValueError(f"unsupported LLR dtype {dtype}; this port decodes float32")


def _dtype_from_name(name: str) -> torch.dtype:
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype name {name!r}")
    return dtype


def resolve_impl(code, dtype, impl: str, device="cuda") -> str:
    """Resolve impl="auto" to a concrete implementation name.

    "auto" is the hand-written CUDA kernel on a CUDA device and the plain
    PyTorch layered decoder on the CPU. Concrete names pass through after
    the same checks, so callers can key caches on the resolved name.
    """
    get_code(code)
    _check_dtype(dtype)
    if impl in _LATER:
        raise ValueError(f"impl {impl!r} is not in this port yet: {impl} {_LATER[impl]}")
    if impl not in IMPLS:
        raise ValueError(f"unknown decoder impl {impl!r} ({'|'.join(IMPLS)})")
    if impl != "auto":
        return impl
    return "cuda_layered" if resolve_device(device).type == "cuda" else "layered"


def _make_decoder(code, dtype, maxiters, alpha, impl: str, device="cuda"):
    """Build the decoder for a (resolved or "auto") impl on `device`.

    "layered": plain PyTorch row-layered self-corrected min-sum;
    "cuda_layered": the same function through the CUDA kernel (its plain
    version on a CPU device). Returns fn(llrs: (B, n)) -> MSResult.
    """
    impl = resolve_impl(code, dtype, impl, device)
    if impl == "layered":
        from ..ops.qc_minsum import make_ms_decoder_layered

        return make_ms_decoder_layered(code, maxiters, alpha, device=device)
    from ..ops.cuda_layered import make_ms_decoder_cuda_layered

    return make_ms_decoder_cuda_layered(code, maxiters, alpha, device=device)


class ChannelStats(NamedTuple):
    trials: torch.Tensor  # () int32 — codewords attempted
    bit_errors: torch.Tensor  # () int32 — data-bit errors after decoding
    frame_errors: torch.Tensor  # () int32 — codewords with any data-bit error
    decode_failures: torch.Tensor  # () int32 — decoder reported non-convergence
    iterations: torch.Tensor  # () int32 — total decoder iterations run


def noise_sigma(snr_db: float, code: LDPCCode | None = None, model: str = "perftest") -> float:
    if model == "perftest":
        # perftest/src/main.rs:15 — sigma = 10^(-snr/10)
        return float(10.0 ** (-snr_db / 10.0))
    if model == "ebn0":
        if code is None:
            raise ValueError("the ebn0 noise model needs the code (its rate)")
        rate = code.k / code.n
        return float((2.0 * rate * 10.0 ** (snr_db / 10.0)) ** -0.5)
    raise ValueError(f"unknown noise model {model!r}")


def _count_stats(batch: int, k: int, data_bits: torch.Tensor, res) -> ChannelStats:
    """Data-bit and frame error counters of one decoded batch."""
    i32 = torch.int32
    bit_err = (res.bits[:, :k] != data_bits).sum(dim=1, dtype=i32)  # (B,)
    return ChannelStats(
        trials=torch.tensor(batch, dtype=i32, device=data_bits.device),
        bit_errors=bit_err.sum(dtype=i32),
        frame_errors=(bit_err > 0).sum(dtype=i32),
        decode_failures=(~res.success).sum(dtype=i32),
        iterations=res.iterations.sum(dtype=i32),
    )


def _bpsk(cw_bits: torch.Tensor) -> torch.Tensor:
    """bit 1 -> -1, bit 0 -> +1 (hard_to_llrs convention, decoder.rs:488-492)."""
    return 1.0 - 2.0 * cw_bits.to(torch.float32)


def _awgn(cw_bits: torch.Tensor, noise: torch.Tensor, sigma) -> torch.Tensor:
    """BPSK plus sigma-scaled standard normal noise, float32."""
    sigma = torch.as_tensor(sigma, dtype=torch.float32, device=cw_bits.device)
    return _bpsk(cw_bits) + noise.to(torch.float32) * sigma


@dataclass(frozen=True, eq=False)
class TrialStep:
    """One batch of trials, fn(gen, param) -> ChannelStats.

    `draw(gen, param)` makes the random inputs: (B, k) data bits and the
    channel's raw noise over the (B, n) codeword, a Bernoulli(param) mask
    (noise="bernoulli") or standard normal samples (noise="normal").
    `apply(data_bits, noise, param)` is the rest, with no randomness:
    encode -> `channel(cw_bits, noise, param)` -> `decoder` -> counters.
    """

    code: LDPCCode
    batch: int
    noise: str  # "bernoulli" | "normal"
    channel: Callable  # (cw_bits, noise, param) -> decoder input
    decoder: Callable  # decoder input (B, n) -> MSResult | BFResult
    impl: str  # the decoder's resolved implementation name
    device: torch.device

    def draw(self, gen: torch.Generator, param: float) -> tuple[torch.Tensor, torch.Tensor]:
        B, dev = self.batch, self.device
        data = torch.randint(0, 2, (B, self.code.k), generator=gen, device=dev, dtype=torch.uint8)
        shape = (B, self.code.n)
        if self.noise == "bernoulli":
            return data, torch.rand(shape, generator=gen, device=dev) < param
        return data, torch.randn(shape, generator=gen, device=dev)

    def apply(self, data_bits, noise, param: float) -> ChannelStats:
        data_bits = torch.as_tensor(data_bits, device=self.device).to(torch.uint8)
        noise = torch.as_tensor(noise, device=self.device)
        cw_bits = encode_bits(self.code, data_bits, self.device)
        res = self.decoder(self.channel(cw_bits, noise, param))
        return _count_stats(self.batch, self.code.k, data_bits, res)

    def __call__(self, gen: torch.Generator, param: float) -> ChannelStats:
        return self.apply(*self.draw(gen, param), param)


def make_trial_step(
    code: LDPCCode | str,
    batch: int,
    maxiters: int = 100,
    dtype_name: str = "float32",
    alpha: float | None = None,
    impl: str = "auto",
    llr_scale: float | None = None,
    device="cuda",
) -> TrialStep:
    """Soft-channel trial step: fn(gen, sigma) -> ChannelStats over `batch`
    codewords: random data -> encode -> BPSK +-1 -> AWGN(sigma) -> min-sum
    -> counters, on `device`. float32 LLRs, unscaled (the reference's
    convention; min-sum is scale-invariant)."""
    code = get_code(code)
    dev = resolve_device(device)
    dtype = _dtype_from_name(dtype_name)
    impl = resolve_impl(code, dtype, impl, dev)
    if llr_scale is not None:
        raise ValueError("llr_scale quantizes int LLRs, which come with ROADMAP Queue A5")
    decoder = _make_decoder(code, dtype, maxiters, alpha, impl, dev)
    return TrialStep(code, batch, "normal", _awgn, decoder, impl, dev)
