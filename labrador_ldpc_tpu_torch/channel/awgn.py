"""Decoder registry, AWGN noise conventions, the LLR quantizer, the soft
trial step and the two-stage decoder.

PyTorch counterpart of `labrador_ldpc_tpu/channel/awgn.py`. The registry's
implementations, with the JAX package's names where they differ:
  * "ref": the reference-order decoder (every dtype: float32, bfloat16,
    float64, int8, int16, int32);
  * "qc": flooding min-sum, plain PyTorch (float32, bfloat16, float64;
    int8/int16 go to the saturating int form), "qc_i8"/"qc_i16" the int form
    explicitly;
  * "layered": row-layered min-sum, plain PyTorch (float32, bfloat16,
    float64, int8, int16);
  * "cuda_layered": the layered CUDA kernel (JAX's "pallas_layered");
  * "cuda_qc": the flooding CUDA kernel (JAX's "pallas_qc"); both kernels
    take float32, bfloat16, int8 and int16, and refuse float64 as the TPU
    kernels do;
  * "sp": flooding sum-product, plain PyTorch;
  * "sp_layered": row-layered sum-product, the CUDA kernel on a CUDA device
    and its plain version on the CPU (as JAX's: the fused kernel on the
    accelerator, the twin elsewhere); "cuda_sp" the same kernel by name
    (JAX's "sp_pallas"). float32 only, no alpha; "auto" never picks them.
A wrapper of a CUDA kernel runs its plain version on a CPU device. A dtype or
alpha an impl does not take raises a ValueError here, instead of failing deep
inside a decoder.

Two noise models (as the JAX package):
  * "perftest": the reference's convention — noise sigma = 10^(-snr/10)
    added directly to +-1 LLRs (perftest/src/main.rs:15; min-sum is
    scale-invariant, decoder.rs:332-335, so the LLRs stay unscaled);
  * "ebn0": BPSK over AWGN at Eb/N0 dB — sigma^2 = 1/(2 R 10^(x/10)).
int8/int16 trial steps quantize the channel's float32 LLRs with
`quantize_llrs` (scale `llr_scale`, default `default_llr_scale`); bfloat16,
float64 and int32 cast them (as the JAX step's astype); the sum-product trial
steps scale them to true channel LLRs 2y/sigma^2 (BP is not
scale-invariant).

A trial step draws its data and noise from an explicit `torch.Generator`
(`TrialStep.draw`) and hands them to a pure function (`TrialStep.apply`):
data -> encode -> channel -> decode -> counters. `torch.Generator` does not
reproduce `jax.random`, so the tests feed `apply` numpy-made data and noise
on both sides.

With a mesh (`parallel.mesh.BatchMesh`), `batch` is the global batch: every
rank draws the whole global batch from the same generator and keeps its own
rows (`parallel.mesh.batch_sharding`), encodes and decodes only those, and
the five counters are summed over the ranks with one `all_reduce`. Every
rank so sees the counters of the one-rank run, bit for bit (the JAX package
gets the same from its placement-invariant threefry). The draw is a small
part of a batch: 0.30-0.42 ms of a 56-94 ms TM8192 waterfall batch of 8192
(PERF.md section 5; NVIDIA H100 80GB HBM3, 700.00 W).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Callable, NamedTuple

import torch

from ..codes.params import LDPCCode, get_code
from ..device import resolve_device
from ..ops.encoder import encode_bits
from ..ops.cuda_layered import make_ms_decoder_cuda_layered
from ..ops.cuda_qc import make_ms_decoder_cuda_qc
from ..ops.cuda_sp import make_sp_decoder_cuda
from ..ops.minsum import DTYPES, INT_DTYPES, MSResult, check_dtype, make_ms_decoder
from ..ops.qc_minsum import (
    KERNEL_DTYPES,
    SAT_DTYPES,
    make_ms_decoder_layered,
    make_ms_decoder_qc,
    make_ms_decoder_qc_int,
)
from ..ops.sumproduct import make_sp_decoder
from ..parallel.mesh import BatchMesh, all_reduce_sum, batch_sharding, shard_decoder
from ..utils.tracing import span

__all__ = [
    "ChannelStats", "TrialStep", "default_llr_scale", "make_trial_step",
    "make_two_stage_decoder", "noise_sigma", "quantize_llrs", "resolve_impl", "SP_IMPLS",
    "shard_map_decoder",
]


# the sum-product family: float32 true channel LLRs, no alpha
SP_IMPLS = ("sp", "sp_layered", "cuda_sp")
IMPLS = ("auto", "ref", "qc", "qc_i8", "qc_i16", "layered", "cuda_layered", "cuda_qc",
         *SP_IMPLS)

# implementations of the JAX package that this port has under another name
_LATER = {
    "pallas_qc": "is the TPU kernel; its CUDA port is impl='cuda_qc'",
    "pallas_layered": "is the TPU kernel; its CUDA port is impl='cuda_layered'",
    "sp_pallas": "is the TPU kernel; its CUDA port is impl='cuda_sp'",
}


def _dtype_from_name(name: str) -> torch.dtype:
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype name {name!r}")
    return dtype


def resolve_impl(code, dtype, impl: str, device="cuda") -> str:
    """Resolve impl="auto" to a concrete implementation name.

    "auto" takes float32, bfloat16, int8 and int16 LLRs to the hand-written
    layered CUDA kernel on a CUDA device and to the plain PyTorch layered
    decoder on the CPU, float64 (which no kernel takes, as Mosaic takes none)
    to the plain layered decoder on every device, and int32 to the
    reference-order decoder (as the JAX package, awgn.py:58-67); it never
    picks sum-product. Concrete names pass through after the same checks, so
    callers can key caches on the resolved name.
    """
    get_code(code)
    if impl in SP_IMPLS and dtype != torch.float32:
        raise ValueError(f"impl {impl!r} supports float32 only")
    check_dtype(dtype, DTYPES)
    if impl in _LATER:
        raise ValueError(f"impl {impl!r} is not in this port: {impl} {_LATER[impl]}")
    if impl not in IMPLS:
        raise ValueError(f"unknown decoder impl {impl!r} ({'|'.join(IMPLS)})")
    if impl != "auto":
        return impl
    if dtype == torch.int32:
        return "ref"
    if dtype == torch.float64:
        return "layered"
    return "cuda_layered" if resolve_device(device).type == "cuda" else "layered"


def _make_decoder(code, dtype, maxiters, alpha, impl: str, device="cuda"):
    """Build the decoder of a (resolved or "auto") impl for `dtype` LLRs on
    `device`; the dtype and alpha rules follow the JAX package's registry
    (awgn.py:106-183). Returns fn(llrs: (B, n)) -> MSResult."""
    impl = resolve_impl(code, dtype, impl, device)
    if impl in SP_IMPLS:
        if alpha is not None:
            raise ValueError(f"impl {impl!r} does not take alpha")
        if impl == "sp":
            return make_sp_decoder(code, maxiters, device=device)
        return make_sp_decoder_cuda(code, maxiters, device=device)
    if impl == "ref":
        if alpha is not None and dtype in INT_DTYPES:
            raise ValueError("normalized min-sum (alpha) requires float LLRs")
        return make_ms_decoder(code, maxiters, alpha, device=device)
    if impl in ("qc_i8", "qc_i16"):
        want = torch.int8 if impl == "qc_i8" else torch.int16
        if dtype != want:
            raise ValueError(f"impl {impl!r} requires dtype {want}, got {dtype}")
    if dtype == torch.int32:
        raise ValueError(f"impl {impl!r} takes float and int8/int16 LLRs; use impl='ref' for "
                         "int32")
    if impl in ("cuda_layered", "cuda_qc") and dtype not in KERNEL_DTYPES:
        raise ValueError(f"impl {impl!r} takes float32/bfloat16/int8/int16 LLRs, as the TPU "
                         "kernels do; float64 goes to impl='layered'|'qc'|'ref'")
    if alpha is not None and dtype in SAT_DTYPES:
        raise ValueError("the saturating int paths do not support alpha (float only)")
    if impl in ("qc", "qc_i8", "qc_i16"):
        if dtype in SAT_DTYPES:
            return make_ms_decoder_qc_int(code, dtype, maxiters, device=device)
        return make_ms_decoder_qc(code, maxiters, alpha, device=device)
    if impl == "layered":
        return make_ms_decoder_layered(code, maxiters, alpha, device=device)
    if impl == "cuda_qc":
        return make_ms_decoder_cuda_qc(code, maxiters, alpha, device=device)
    return make_ms_decoder_cuda_layered(code, maxiters, alpha, device=device)


def shard_map_decoder(decoder, mesh: BatchMesh, result_type=MSResult):
    """`parallel.mesh.shard_decoder` under the JAX package's name and
    signature (labrador_ldpc_tpu/channel/awgn.py:191). The JAX shard_map
    fails when the decoder's result is not `result_type`; so does this, with
    a TypeError at the call."""
    sharded = shard_decoder(decoder, mesh)

    def decode(x):
        res = sharded(x)
        if type(res) is not result_type:
            raise TypeError(f"the decoder returned a {type(res).__name__}, "
                            f"not the result_type {result_type.__name__}")
        return res

    return decode


def default_llr_scale(dtype: torch.dtype) -> float:
    """Default quantizer scale of an int LLR dtype: 16 for int8 (the signal
    at +-16, clipping at about 8 sigma in the waterfall region), 256 for
    int16. Min-sum is scale-invariant (decoder.rs:332-335): only the
    quantization and clipping noise move the BER."""
    if dtype == torch.int8:
        return 16.0
    if dtype == torch.int16:
        return 256.0
    raise ValueError(f"no default LLR scale for dtype {dtype}")


def quantize_llrs(llrs, dtype: torch.dtype, scale: float | None = None) -> torch.Tensor:
    """Quantize float32 channel LLRs to int8/int16: clip(round(llr * scale)).

    Rounds half to even (as jnp.round) and clips before the cast, so no
    float outside the int range is ever cast. A bare cast would truncate
    +-1 +- noise to {-1, 0, 1} and lose most of the soft information.
    """
    if dtype not in SAT_DTYPES:
        raise ValueError(f"quantize_llrs makes int8 or int16 LLRs, not {dtype}")
    if scale is None:
        scale = default_llr_scale(dtype)
    info = torch.iinfo(dtype)
    llrs = torch.as_tensor(llrs)
    return torch.clamp(torch.round(llrs * scale), info.min, info.max).to(dtype)


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
    encode -> `channel(cw_bits, noise, param)` -> `decoder` -> counters,
    each stage a span (`utils.tracing`: `ldpc.encode`, `ldpc.channel`,
    `ldpc.decode`, `ldpc.count`).
    With a `mesh`, `batch` is the global batch, `draw` makes all of it,
    `apply` takes all of it and decodes this rank's rows, and the counters
    are summed over the mesh's ranks.
    """

    code: LDPCCode
    batch: int
    noise: str  # "bernoulli" | "normal"
    channel: Callable  # (cw_bits, noise, param) -> decoder input
    decoder: Callable  # decoder input (B, n) -> MSResult | BFResult
    impl: str  # the decoder's resolved implementation name
    device: torch.device
    mesh: BatchMesh | None = None

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
        if self.mesh is not None:
            rows = batch_sharding(self.mesh, self.batch)
            data_bits, noise = data_bits[rows], noise[rows]
        with span("ldpc.encode"):
            cw_bits = encode_bits(self.code, data_bits, self.device)
        with span("ldpc.channel"):
            rx = self.channel(cw_bits, noise, param)
        with span("ldpc.decode"):
            res = self.decoder(rx)
        with span("ldpc.count"):
            stats = _count_stats(data_bits.shape[0], self.code.k, data_bits, res)
        if self.mesh is None:
            return stats
        return ChannelStats(*all_reduce_sum(self.mesh, torch.stack(stats)))

    def __call__(self, gen: torch.Generator, param: float, index: int | None = None
                 ) -> ChannelStats:
        """draw, then apply; traced as `ldpc.trial_step` (args batch: `index`,
        where the caller gives the batch's index in its sweep)."""
        with span("ldpc.trial_step", "batch", index):
            with span("ldpc.draw"):
                drawn = self.draw(gen, param)
            return self.apply(*drawn, param)


def _awgn_llrs(cw_bits: torch.Tensor, noise: torch.Tensor, sigma, dtype: torch.dtype,
               llr_scale: float | None) -> torch.Tensor:
    """The AWGN channel's LLRs in the decoder's dtype: quantized for
    int8/int16, cast for the others (rounded to nearest for bfloat16,
    widened for float64, truncated toward zero for int32, as the JAX
    package's astype)."""
    soft = _awgn(cw_bits, noise, sigma)
    if dtype in SAT_DTYPES:
        return quantize_llrs(soft, dtype, llr_scale)
    return soft.to(dtype)


def _awgn_true_llrs(cw_bits: torch.Tensor, noise: torch.Tensor, sigma) -> torch.Tensor:
    """The AWGN channel's true LLRs 2y/sigma^2 in float32, as the JAX package
    computes them (awgn.py:344-348): sigma*sigma, then 2 divided by it, then
    the product. (`2.0 / tensor` would multiply by a reciprocal instead.)"""
    soft = _awgn(cw_bits, noise, sigma)
    s = torch.as_tensor(sigma, dtype=torch.float32, device=soft.device)
    two = torch.tensor(2.0, dtype=torch.float32, device=soft.device)
    return soft * torch.div(two, s * s)


def _step_device(device, mesh: BatchMesh | None, batch: int) -> torch.device:
    """The device of a trial step: `device`, or with a mesh the mesh's
    device, which must be of the same type (no rank runs on the CPU when it
    was asked for CUDA); the global batch must divide by the ranks."""
    dev = resolve_device(device)
    if mesh is None:
        return dev
    if mesh.device.type != dev.type:
        raise ValueError(f"the mesh's ranks run on {mesh.device}, the step was asked for {dev}")
    batch_sharding(mesh, batch)
    return mesh.device


def make_trial_step(
    code: LDPCCode | str,
    batch: int,
    maxiters: int = 100,
    dtype_name: str = "float32",
    alpha: float | None = None,
    impl: str = "auto",
    llr_scale: float | None = None,
    device="cuda",
    mesh: BatchMesh | None = None,
) -> TrialStep:
    """Soft-channel trial step: fn(gen, sigma) -> ChannelStats over `batch`
    codewords: random data -> encode -> BPSK +-1 -> AWGN(sigma) -> LLRs in
    `dtype_name` -> decode -> counters, on `device`. float32 LLRs stay
    unscaled for min-sum (the reference's convention; min-sum is
    scale-invariant) and become true LLRs 2y/sigma^2 for the sum-product
    impls (`SP_IMPLS`); int8 and int16 are quantized with `quantize_llrs` at
    `llr_scale` (default `default_llr_scale`), which no other dtype takes;
    bfloat16, float64 and int32 are the float32 LLRs cast. With `mesh`,
    `batch` is the global batch, split over the mesh's ranks (`TrialStep`),
    and the step runs on the mesh's device."""
    code = get_code(code)
    dev = _step_device(device, mesh, batch)
    dtype = _dtype_from_name(dtype_name)
    impl = resolve_impl(code, dtype, impl, dev)
    if llr_scale is not None and dtype not in SAT_DTYPES:
        raise ValueError(f"llr_scale quantizes int8/int16 LLRs; dtype {dtype_name} takes none")
    decoder = _make_decoder(code, dtype, maxiters, alpha, impl, dev)
    if impl in SP_IMPLS:
        channel = _awgn_true_llrs
    elif dtype == torch.float32:
        channel = _awgn
    else:
        channel = partial(_awgn_llrs, dtype=dtype, llr_scale=llr_scale)
    return TrialStep(code, batch, "normal", channel, decoder, impl, dev, mesh)


def make_two_stage_decoder(
    code: LDPCCode | str,
    maxiters_fast: int = 25,
    maxiters_rescue: int = 100,
    dtype: torch.dtype = torch.bfloat16,
    rescue_dtype: torch.dtype = torch.float32,
    fast_impl: str = "cuda_layered",
    rescue_impl: str = "cuda_qc",
    device="cuda",
):
    """Two-stage decode: a layered fast pass, then a flooding rescue of the
    frames it did not converge (JAX package: channel/awgn.py:368-464).

    Stage 1 decodes every frame with `fast_impl` on the LLRs cast to `dtype`;
    stage 2 re-decodes only the failed frames, gathered on the device from
    the ORIGINAL LLRs and cast to `rescue_dtype`, with `rescue_impl`. A
    rescued frame reports the rescue's bits and success, and as iterations
    the fast pass's plus the rescue's. The one device-to-host transfer is the
    (B,) success mask of stage 1. The defaults pair the layered kernel's
    bfloat16 form with the flooding kernel in float32, the pairing the JAX
    package names for its accelerator; on the CPU their wrappers run the
    plain versions. Returns fn(llrs: (B, n)) -> MSResult.
    """
    code = get_code(code)
    dev = resolve_device(device)
    fast = _make_decoder(code, dtype, maxiters_fast, None, fast_impl, dev)
    rescue = _make_decoder(code, rescue_dtype, maxiters_rescue, None, rescue_impl, dev)

    def decode(llrs) -> MSResult:
        llrs = torch.as_tensor(llrs, device=dev)
        res = fast(llrs.to(dtype))
        success = res.success.cpu()
        if bool(success.all()):
            return res
        idx = torch.nonzero(~success).squeeze(1).to(dev)
        r2 = rescue(llrs.index_select(0, idx).to(rescue_dtype))
        return MSResult(
            success=res.success.index_copy(0, idx, r2.success),
            iterations=res.iterations.index_copy(0, idx, res.iterations[idx] + r2.iterations),
            bits=res.bits.index_copy(0, idx, r2.bits),
        )

    return decode
