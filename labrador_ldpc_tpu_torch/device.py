"""Device selection shared by the port's entry points.

Every entry point (encode, hard_to_llrs, decode_ms, the decoder factories)
takes `device=` and runs on CUDA unless the caller asks for the CPU. With no
card present a CUDA request raises here instead of silently running on the
CPU. `describe_card` names the device a measurement ran on, with the card's
power limit beside it (a card set below its maximum runs slower under load).
"""

from __future__ import annotations

import subprocess

import torch

__all__ = ["describe_card", "resolve_device"]


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


def describe_card(device: str | torch.device = "cuda") -> dict:
    """{"name", "power_limit_w", "smi"} of `device`: the card's name
    (`torch.cuda.get_device_name`), its power limit in watts and the line
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` prints for
    it (both None where nvidia-smi cannot say); on the CPU the name "cpu"."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return {"name": "cpu", "power_limit_w": None, "smi": None}
    index = torch.cuda.current_device() if dev.index is None else dev.index
    out = {"name": torch.cuda.get_device_name(index), "power_limit_w": None, "smi": None}
    try:
        lines = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return out
    if index < len(lines):
        out["smi"] = lines[index].strip()
        watts = out["smi"].rsplit(",", 1)[-1].strip().split(" ")[0]
        try:
            out["power_limit_w"] = float(watts)
        except ValueError:
            pass
    return out
