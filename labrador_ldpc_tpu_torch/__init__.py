"""labrador_ldpc_tpu_torch — the PyTorch + CUDA port of labrador_ldpc_tpu.

The same CCSDS LDPC codec for one NVIDIA H100, beside the JAX package (which
stays the reference and is never imported from here). So far it carries the
nine code tables, the converters, the batched GF(2) encoder, the row-layered
(csrc/layered_minsum.cu) and flooding (csrc/flooding_minsum.cu)
self-corrected min-sum decoders in float32, bfloat16 (the kernels' bf16
storage form), float64 (plain PyTorch) and saturating int8/int16, the
two-stage decoder (layered fast pass, flooding rescue), the reference-order
decoder (every dtype), the LLR quantizer, the
Gallager bit-flip and erasure decoders (csrc/bitflip.cu), the sum-product
decoders (flooding, and row-layered with csrc/sumproduct.cu), the AWGN, BSC
and BEC trial steps and the BER/FER waterfall (also `python -m
labrador_ldpc_tpu_torch waterfall`), the waterfall and decoders split over
the ranks of a process group (`parallel/`), the kernels' launch table and
memory sizes (`ops/routing.py`, `sizes.py`, `python -m
labrador_ldpc_tpu_torch sizes`), the serving loop (`serve.py`), the
measurement entry points (`bench.py`, `bench_suite.py`, `profile_decode.py`,
each on the card only), the bindings of the native scalar codec
(`capi.py`) and the quality tools (`tools/`: the anchor, curve, gap and
BSC-threshold generators, and `tools.compare`, which holds their tables in
`results/` to the TPU's).

Entry points run on CUDA unless the caller passes device="cpu"::

    import torch
    import labrador_ldpc_tpu_torch as ldpc

    code = ldpc.LDPCCode.TM8192
    cw   = ldpc.encode(code, data_bytes)              # (B, k/8) -> (B, n/8)
    llrs = ldpc.hard_to_llrs(cw, torch.float32)       # or soft demod output
    res  = ldpc.decode_ms(code, llrs, maxiters=50)    # the layered CUDA kernel
    q    = ldpc.quantize_llrs(soft, torch.int8)       # 8-bit soft bits, scale 16
    res  = ldpc.decode_ms(code, q, impl="cuda_qc")    # the flooding CUDA kernel
    res  = ldpc.decode_ms(code, llrs.to(torch.bfloat16))  # the kernel's bf16 form
    res  = ldpc.make_two_stage_decoder(code)(llrs)    # bf16 layered + f32 flooding
    res  = ldpc.decode_bf(code, ldpc.unpack_bits(cw)) # the bit-flip CUDA kernel
    data = ldpc.pack_bits(res.bits[:, :code.k])
    pts  = ldpc.waterfall(code, [0.006], batch=8192, noise_model="bsc", decoder="bf")
    pts  = ldpc.waterfall(code, [0.9], batch=8192, noise_model="ebn0", impl="sp_layered")
"""

from .codes.params import ALL_CODES, TC_CODES, TM_CODES, CodeParams, LDPCCode, get_code
from .codes.expand import (
    decoder_tables,
    generator_parity_matrix,
    parity_check_matrix,
    parity_edges,
    qc_structure,
)
from .channel.awgn import (
    default_llr_scale,
    make_two_stage_decoder,
    quantize_llrs,
    resolve_impl,
)
from .device import resolve_device
from .ops.convert import hard_to_llrs, llrs_to_hard, pack_bits, unpack_bits
from .ops.encoder import encode, encode_bits, encode_onto, make_encoder
from .ops.minsum import MSResult, decode_ms, make_ms_decoder
from .ops.qc_minsum import (
    make_ms_decoder_layered,
    make_ms_decoder_qc,
    make_ms_decoder_qc_i8,
    make_ms_decoder_qc_int,
)
from .ops.cuda_layered import make_ms_decoder_cuda_layered
from .ops.cuda_qc import make_ms_decoder_cuda_qc
from .ops.bitflip import (
    BFResult,
    decode_bf,
    decode_erasures_bits,
    decode_erasures_mask,
    make_bf_decoder,
    make_bf_decoder_qc,
)
from .ops.cuda_bf import make_bf_decoder_cuda
from .ops.sumproduct import make_sp_decoder, make_sp_decoder_layered
from .ops.cuda_sp import make_sp_decoder_cuda
from .channel.awgn import ChannelStats, noise_sigma
from .channel.waterfall import SnrPoint, waterfall

__version__ = "0.1.0"

__all__ = [
    "LDPCCode", "CodeParams", "get_code", "ALL_CODES", "TC_CODES", "TM_CODES",
    "parity_edges", "parity_check_matrix", "generator_parity_matrix", "decoder_tables",
    "qc_structure",
    "encode", "encode_bits", "encode_onto", "make_encoder",
    "decode_ms", "MSResult", "make_ms_decoder", "make_ms_decoder_layered",
    "make_ms_decoder_cuda_layered", "make_ms_decoder_qc", "make_ms_decoder_qc_int",
    "make_ms_decoder_qc_i8", "make_ms_decoder_cuda_qc", "make_two_stage_decoder",
    "quantize_llrs", "default_llr_scale",
    "decode_bf", "BFResult", "decode_erasures_bits", "decode_erasures_mask",
    "make_bf_decoder", "make_bf_decoder_qc", "make_bf_decoder_cuda",
    "make_sp_decoder", "make_sp_decoder_layered", "make_sp_decoder_cuda",
    "waterfall", "SnrPoint", "noise_sigma", "ChannelStats",
    "resolve_impl", "resolve_device",
    "hard_to_llrs", "llrs_to_hard", "pack_bits", "unpack_bits",
    "__version__",
]
