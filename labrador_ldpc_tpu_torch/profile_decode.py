"""Profile a decode on the card and print its top device operations.

Counterpart of `tools/profile_decode.py` (the JAX package's TPU trace):
`torch.profiler.profile(activities=[CPU, CUDA])` around `--reps` decodes
after a warm-up decode (and one more inside the profiler, whose events are
dropped: it absorbs the profiler's own start), each decode waited for (as
`jax.block_until_ready` does there). It prints the `--top` device
operations by total time, the window's device busy share (the union of the
device intervals over the window from the first to the last recorded
event, host and device) and the three longest idle gaps of the device in
it. `--trace-dir` keeps the Chrome trace (`export_chrome_trace`).

The input is the 3-flip scenario of `bench`: `--batch` codewords of
`--code` (`serve.flipped_codewords`: data bytes from
`np.random.default_rng(0)`, byte 0 XOR 0xA8); the
soft impls take `hard_to_llrs` in `--dtype` (int8/int16 through
`quantize_llrs` at its default scale, as the JAX tool), the bit-flip ones
(`bf`, `bf_qc`, `bf_cuda`) the hard bits.

    python -m labrador_ldpc_tpu_torch.profile_decode --code TM8192 \\
        --impl cuda_layered --dtype float32 --batch 16384 --top 10

It runs on the card only. If the profiler records no device activity it
raises and says so; it never falls back to another timer. `aggregate` is a
pure function of `(name, start, end)` events, so that the tests reach it.
"""

from __future__ import annotations

import argparse
import os
from dataclasses import dataclass

import torch

from .channel.awgn import _make_decoder, quantize_llrs
from .codes.params import get_code
from .device import describe_card, resolve_device
from .ops.bitflip import make_bf_decoder, make_bf_decoder_qc
from .ops.convert import hard_to_llrs, unpack_bits
from .ops.cuda_bf import make_bf_decoder_cuda
from .serve import flipped_codewords

__all__ = ["NoDeviceActivity", "Profile", "aggregate", "format_profile", "profile_decode", "main"]

SOFT_IMPLS = ("ref", "qc", "qc_i8", "qc_i16", "layered", "cuda_qc", "cuda_layered")
BF_IMPLS = {"bf": make_bf_decoder, "bf_qc": make_bf_decoder_qc, "bf_cuda": make_bf_decoder_cuda}
GAPS = 3  # idle gaps printed


class NoDeviceActivity(RuntimeError):
    """The profiler recorded no device event in the profiled window."""


@dataclass(frozen=True)
class Profile:
    window: tuple[float, float]  # (start, end) of the window, the events' unit
    busy: float  # union of the device intervals over the window's length
    top: list[tuple[str, float, int]]  # (name, total time, count), most time first
    gaps: list[tuple[float, float]]  # (start, length) of the longest idle gaps, longest first


def aggregate(events, window: tuple[float, float] | None = None, top: int = 20,
              gaps: int = GAPS) -> Profile:
    """Aggregate device events `(name, start, end)` (one unit throughout, µs
    from the profiler) over `window` (default: from the first start to the
    last end): each name's total time and count, the share of the window the
    union of the intervals covers, and the longest stretches of the window
    no interval covers."""
    events = [(name, float(s), float(e)) for name, s, e in events]
    if not events:
        raise ValueError("no device events to aggregate")
    if window is None:
        window = (min(s for _, s, _ in events), max(e for _, _, e in events))
    w0, w1 = window
    totals: dict[str, float] = {}
    counts: dict[str, int] = {}
    for name, s, e in events:
        totals[name] = totals.get(name, 0.0) + (e - s)
        counts[name] = counts.get(name, 0) + 1
    ranked = sorted(totals, key=lambda n: -totals[n])[:top]
    busy, idle, cursor = 0.0, [], w0
    for _, s, e in sorted(events, key=lambda ev: ev[1]):
        s, e = max(s, w0), min(e, w1)
        if e <= cursor:
            continue
        if s > cursor:
            idle.append((cursor, s - cursor))
        busy += e - max(s, cursor)
        cursor = e
    if w1 > cursor:
        idle.append((cursor, w1 - cursor))
    idle.sort(key=lambda g: -g[1])
    return Profile(window, busy / max(w1 - w0, 1e-30),
                   [(n, totals[n], counts[n]) for n in ranked], idle[:gaps])


def _inputs(code, impl: str, dtype: torch.dtype, batch: int, dev: torch.device):
    cw = flipped_codewords(code, batch, dev)[1]
    if impl in BF_IMPLS:
        return unpack_bits(cw, dev)
    if impl in ("qc_i8", "qc_i16") or dtype in (torch.int8, torch.int16):
        if dtype not in (torch.int8, torch.int16):
            dtype = torch.int8 if impl == "qc_i8" else torch.int16
        return quantize_llrs(hard_to_llrs(cw, torch.float32, dev), dtype)
    return hard_to_llrs(cw, dtype, dev)


def profile_decode(code="TM8192", impl: str = "cuda_layered", dtype: torch.dtype = torch.float32,
                   batch: int = 4096, maxiters: int = 50, reps: int = 3, top: int = 20,
                   trace_dir: str | None = None, device="cuda") -> Profile:
    """Profile `reps` decodes of the 3-flip batch (after one warm-up) and
    aggregate the device events over the profiled window."""
    code = get_code(code)
    dev = resolve_device(device)
    if impl not in SOFT_IMPLS and impl not in BF_IMPLS:
        raise ValueError(f"unknown impl {impl!r} ({'|'.join((*SOFT_IMPLS, *BF_IMPLS))})")
    x = _inputs(code, impl, dtype, batch, dev)
    if impl in BF_IMPLS:
        dec = BF_IMPLS[impl](code, maxiters, device=dev)
    else:
        dec = _make_decoder(code, x.dtype, maxiters, None, impl, dev)
    cuda = dev.type == "cuda"

    def wait():
        if cuda:
            torch.cuda.synchronize(dev)

    dec(x)  # build the decoder and load the kernel
    wait()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    # one decode of warm-up inside the profiler: the profiler's first launch
    # requests its activity buffers (about 3 ms of host time on an H100),
    # which would otherwise show as device idle time in the window
    schedule = torch.profiler.schedule(wait=0, warmup=1, active=reps, repeat=1)
    with torch.profiler.profile(activities=activities, schedule=schedule) as prof:
        for _ in range(1 + reps):
            dec(x)
            wait()
            prof.step()
    if trace_dir is not None:
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, f"decode_{code.value}_{impl}.json"))
    events = list(prof.events())
    recorded = [(e.name, e.time_range.start, e.time_range.end) for e in events]
    # the device's own work: kineto also mirrors the step annotations
    # (`ProfilerStep#n`) onto the device timeline, which are no operation
    device_events = [r for r, e in zip(recorded, events)
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and not e.is_user_annotation and not e.name.startswith("ProfilerStep")]
    if not device_events:
        raise NoDeviceActivity(
            f"torch.profiler recorded no CUDA activity on {describe_card(dev)['name']}: it sees "
            "no device time here, so there is nothing to aggregate")
    window = (min(s for _, s, _ in recorded), max(e for _, _, e in recorded))
    return aggregate(device_events, window, top)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--code", default="TM8192")
    ap.add_argument("--impl", default="cuda_qc", choices=[*SOFT_IMPLS, *BF_IMPLS])
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--maxiters", type=int, default=50)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--trace-dir", default=None, help="keep the Chrome trace here")
    args = ap.parse_args(argv)
    dtype = getattr(torch, args.dtype)
    card = describe_card("cuda")  # raises without a card
    p = profile_decode(args.code, args.impl, dtype, args.batch, args.maxiters, args.reps,
                       args.top, args.trace_dir, device="cuda")
    on = card["smi"] or card["name"]
    print(format_profile(p, f"{args.code} {args.impl} {args.dtype} B={args.batch} maxiters="
                            f"{args.maxiters}, {args.reps} decodes on {on}"))
    return 0


def format_profile(p: Profile, header: str) -> str:
    """The report: `header`, the window and busy share, the top operations
    and the idle gaps (times in ms; the profiler's events are in µs)."""
    w = (p.window[1] - p.window[0]) / 1e3
    lines = [f"== {header}: window {w:.3f} ms, device busy {p.busy:.1%}"]
    for name, total, count in p.top:
        lines.append(f"  {total / 1e3:10.3f} ms  x{count:<5} {name[:100]}")
    lines.append("  longest idle gaps: " + ", ".join(
        f"{length / 1e3:.3f} ms at +{(start - p.window[0]) / 1e3:.3f} ms"
        for start, length in p.gaps))
    return "\n".join(lines)


if __name__ == "__main__":
    raise SystemExit(main())
