"""labrador_ldpc_tpu_torch — the PyTorch + CUDA port of labrador_ldpc_tpu.

The same CCSDS LDPC codec for one NVIDIA H100, beside the JAX package (which
stays the reference and is never imported from here). This slice carries the
nine code tables, the converters, the batched GF(2) encoder and the
row-layered self-corrected min-sum decode, float32, through a hand-written
CUDA kernel (csrc/layered_minsum.cu).

Entry points run on CUDA unless the caller passes device="cpu"::

    import torch
    import labrador_ldpc_tpu_torch as ldpc

    code = ldpc.LDPCCode.TM8192
    cw   = ldpc.encode(code, data_bytes)              # (B, k/8) -> (B, n/8)
    llrs = ldpc.hard_to_llrs(cw, torch.float32)       # or soft demod output
    res  = ldpc.decode_ms(code, llrs, maxiters=50)    # the CUDA kernel
    data = ldpc.pack_bits(res.bits[:, :code.k])
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

__version__ = "0.1.0"

__all__ = [
    "LDPCCode", "CodeParams", "get_code", "ALL_CODES", "TC_CODES", "TM_CODES",
    "parity_edges", "parity_check_matrix", "generator_parity_matrix", "decoder_tables",
    "qc_structure",
    "encode", "encode_bits", "encode_onto", "make_encoder",
    "decode_ms", "MSResult", "make_ms_decoder_layered", "make_ms_decoder_cuda_layered",
    "resolve_impl", "resolve_device",
    "hard_to_llrs", "llrs_to_hard", "pack_bits", "unpack_bits",
    "__version__",
]
