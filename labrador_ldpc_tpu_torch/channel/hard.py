"""Hard-decision channels for the bit-flip and hard-input min-sum surfaces.

PyTorch counterpart of `labrador_ldpc_tpu/channel/hard.py`. The reference
documents a bit-flip vs min-sum tradeoff ("between one and two dB worse ...
but a few times quicker", src/lib.rs:165-172) without a statistical
harness; these trial steps are that harness:

  * "bsc": every transmitted bit flips i.i.d. with probability p (the sweep
    variable; there is no dB axis);
  * "bec": every transmitted bit is erased to 0 i.i.d. with probability f
    (the reference's residual-erasure convention, decoder.rs:167: an erased
    1 is an error for the decoder to fix);
  * "perftest"/"ebn0": the soft AWGN channel of `awgn.py` at sigma,
    hard-sliced before decoding, so bit-flip and min-sum curves at equal dB
    differ by the decoders alone.
"""

from __future__ import annotations

import torch

from ..codes.params import LDPCCode, get_code
from ..device import resolve_device
from .awgn import ChannelStats, TrialStep, _awgn, _bpsk, _count_stats, _make_decoder, resolve_impl

__all__ = ["ChannelStats", "make_bf_trial_step", "make_ms_hard_trial_step", "resolve_bf_impl"]

BF_IMPLS = ("auto", "cuda", "qc", "gather")


def resolve_bf_impl(code, impl: str, device="cuda") -> str:
    """Resolve impl="auto" for the bit-flip surface: the hand-written CUDA
    kernel on a CUDA device, the plain QC decoder on the CPU (its plain
    version, bit for bit the same function)."""
    get_code(code)
    if impl == "pallas":
        raise ValueError("bf impl 'pallas' is the TPU kernel; its CUDA port is impl='cuda'")
    if impl not in BF_IMPLS:
        raise ValueError(f"unknown bf impl {impl!r} ({'|'.join(BF_IMPLS)})")
    if impl != "auto":
        return impl
    return "cuda" if resolve_device(device).type == "cuda" else "qc"


def _make_bf_decoder(code, maxiters: int, impl: str, device="cuda"):
    impl = resolve_bf_impl(code, impl, device)
    if impl == "cuda":
        from ..ops.cuda_bf import make_bf_decoder_cuda

        return make_bf_decoder_cuda(code, maxiters, device)
    if impl == "qc":
        from ..ops.bitflip import make_bf_decoder_qc

        return make_bf_decoder_qc(code, maxiters, device)
    from ..ops.bitflip import make_bf_decoder

    return make_bf_decoder(code, maxiters, device)


def _hard_channel_rx(channel: str, cw_bits: torch.Tensor, noise: torch.Tensor, param) -> torch.Tensor:
    """Received hard bits (uint8) of the hard channels: 'bsc' flips where
    the Bernoulli mask `noise` is set, 'bec' erases to 0 there, and
    'perftest'/'ebn0' add sigma=`param` times the normal samples `noise` to
    BPSK +-1 and slice."""
    if channel == "bsc":
        return cw_bits ^ noise.to(torch.uint8)
    if channel == "bec":
        return cw_bits * (1 - noise.to(torch.uint8))
    return (_awgn(cw_bits, noise, param) < 0).to(torch.uint8)


def _noise_kind(channel: str, allowed: tuple[str, ...]) -> str:
    if channel not in allowed:
        raise ValueError(f"unknown hard channel {channel!r} ({'|'.join(allowed)})")
    return "bernoulli" if channel in ("bsc", "bec") else "normal"


def make_bf_trial_step(
    code: LDPCCode | str,
    batch: int,
    maxiters: int = 50,
    channel: str = "bsc",
    impl: str = "auto",
    device="cuda",
) -> TrialStep:
    """Hard-decision trial step: fn(gen, param) -> ChannelStats over `batch`
    codewords: random data -> encode -> hard channel -> bit-flip decode ->
    counters, on `device`. `param` is the flip probability p ("bsc"), the
    erasure probability f ("bec"), or the noise sigma of the AWGN
    hard-decision channels ("perftest"/"ebn0"; `awgn.noise_sigma` maps dB
    to sigma)."""
    code = get_code(code)
    dev = resolve_device(device)
    noise = _noise_kind(channel, ("bsc", "bec", "perftest", "ebn0"))
    impl = resolve_bf_impl(code, impl, dev)
    decoder = _make_bf_decoder(code, maxiters, impl, dev)

    def rx(cw_bits, n, param):
        return _hard_channel_rx(channel, cw_bits, n, param)

    return TrialStep(code, batch, noise, rx, decoder, impl, dev)


def make_ms_hard_trial_step(
    code: LDPCCode | str,
    batch: int,
    maxiters: int = 50,
    channel: str = "bsc",
    impl: str = "auto",
    device="cuda",
) -> TrialStep:
    """Min-sum driven by hard channel output: the hard bits enter as +-1
    LLRs (the decode_ms side of the reference's bit-flip vs min-sum
    framing, src/lib.rs:160-172). Same channels and `param` as
    `make_bf_trial_step`, except "bec"."""
    code = get_code(code)
    dev = resolve_device(device)
    noise = _noise_kind(channel, ("bsc", "perftest", "ebn0"))
    impl = resolve_impl(code, torch.float32, impl, dev)
    decoder = _make_decoder(code, torch.float32, maxiters, None, impl, dev)

    def llrs(cw_bits, n, param):
        return _bpsk(_hard_channel_rx(channel, cw_bits, n, param))

    return TrialStep(code, batch, noise, llrs, decoder, impl, dev)
