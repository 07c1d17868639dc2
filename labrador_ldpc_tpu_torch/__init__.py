"""labrador_ldpc_tpu_torch — the PyTorch + CUDA port of labrador_ldpc_tpu.

The same CCSDS LDPC codec for one NVIDIA H100, beside the JAX package (which
stays the reference and is never imported from here). So far it carries the
nine code tables, the converters, the batched GF(2) encoder, the row-layered
self-corrected min-sum decode (float32, csrc/layered_minsum.cu), the
Gallager bit-flip and erasure decoders (csrc/bitflip.cu), the AWGN, BSC and
BEC trial steps and the BER/FER waterfall (also `python -m
labrador_ldpc_tpu_torch waterfall`).

Entry points run on CUDA unless the caller passes device="cpu"::

    import torch
    import labrador_ldpc_tpu_torch as ldpc

    code = ldpc.LDPCCode.TM8192
    cw   = ldpc.encode(code, data_bytes)              # (B, k/8) -> (B, n/8)
    llrs = ldpc.hard_to_llrs(cw, torch.float32)       # or soft demod output
    res  = ldpc.decode_ms(code, llrs, maxiters=50)    # the layered CUDA kernel
    res  = ldpc.decode_bf(code, ldpc.unpack_bits(cw)) # the bit-flip CUDA kernel
    data = ldpc.pack_bits(res.bits[:, :code.k])
    pts  = ldpc.waterfall(code, [0.006], batch=8192, noise_model="bsc", decoder="bf")
"""

from .codes.params import ALL_CODES, TC_CODES, TM_CODES, CodeParams, LDPCCode, get_code
from .codes.expand import (
    decoder_tables,
    generator_parity_matrix,
    parity_check_matrix,
    parity_edges,
    qc_structure,
)
from .channel.awgn import resolve_impl
from .device import resolve_device
from .ops.convert import hard_to_llrs, llrs_to_hard, pack_bits, unpack_bits
from .ops.encoder import encode, encode_bits, encode_onto, make_encoder
from .ops.minsum import MSResult, decode_ms
from .ops.qc_minsum import make_ms_decoder_layered
from .ops.cuda_layered import make_ms_decoder_cuda_layered
from .ops.bitflip import (
    BFResult,
    decode_bf,
    decode_erasures_bits,
    decode_erasures_mask,
    make_bf_decoder,
    make_bf_decoder_qc,
)
from .ops.cuda_bf import make_bf_decoder_cuda
from .channel.awgn import ChannelStats, noise_sigma
from .channel.waterfall import SnrPoint, waterfall

__version__ = "0.1.0"

__all__ = [
    "LDPCCode", "CodeParams", "get_code", "ALL_CODES", "TC_CODES", "TM_CODES",
    "parity_edges", "parity_check_matrix", "generator_parity_matrix", "decoder_tables",
    "qc_structure",
    "encode", "encode_bits", "encode_onto", "make_encoder",
    "decode_ms", "MSResult", "make_ms_decoder_layered", "make_ms_decoder_cuda_layered",
    "decode_bf", "BFResult", "decode_erasures_bits", "decode_erasures_mask",
    "make_bf_decoder", "make_bf_decoder_qc", "make_bf_decoder_cuda",
    "waterfall", "SnrPoint", "noise_sigma", "ChannelStats",
    "resolve_impl", "resolve_device",
    "hard_to_llrs", "llrs_to_hard", "pack_bits", "unpack_bits",
    "__version__",
]
