"""Device selection shared by the port's entry points.

Every entry point (encode, hard_to_llrs, decode_ms, the decoder factories)
takes `device=` and runs on CUDA unless the caller asks for the CPU. With no
card present a CUDA request raises here instead of silently running on the
CPU.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """`device` as a torch.device; raises if it names CUDA and there is none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
