"""Headline benchmark of the port: decoded codewords/s on one card, TM8192.

Counterpart of the repository's `bench.py` (the JAX package on a TPU): the
reference's decode microbenchmark scenario (benches/decode.rs:39-71) at
batch size. TM8192 (k=4096, r=1/2), B=16384 frames by default, data bytes
from `np.random.default_rng(0)`, encoded, 3 bits of byte 0 flipped
(`serve.flipped_codewords`, the serving loop's frames), `hard_to_llrs` in
float32, min-sum with maxiters 50 through
`channel.awgn._make_decoder`; every frame must converge.

    python -m labrador_ldpc_tpu_torch.bench [B]

`BENCH_IMPL` picks the decoder (default `cuda_layered`, the layered CUDA
kernel, the port's name for `pallas_layered`); `BENCH_PIPELINE` the longest
train (default 32). Timing is `utils.timing.pipelined_fit`: trains of K/4,
K/2, 3K/4 and K decodes enqueued back to back, best of 3 each, synchronised
by a copy of the last decode's first success flag to the host (launches on
one stream run in order, so the copy cannot finish early); the rate is the
least-squares slope, never more than 1.5x the K-train's amortized rate.

Standard output is exactly one JSON line, `{"metric", "value", "unit",
"vs_baseline", "device"}`, under a metric name of its own, so that the TPU
series of `bench.py` stays apart; `vs_baseline` is the ratio to the first
value measured on an H100 (`bench_baseline.json` beside this module, with
the card's name and power limit). The fit's points, residuals and R^2 and
the card's name and power limit go to standard error. There is no CPU mode:
`main()` raises without a card; tests call `measure(device="cpu")`.
"""

from __future__ import annotations

import json
import os
import sys
import time
from dataclasses import dataclass
from pathlib import Path

import torch

from .channel.awgn import _make_decoder
from .codes.params import get_code
from .device import describe_card, resolve_device
from .ops.convert import hard_to_llrs
from .serve import flipped_codewords
from .utils.timing import Fit, pipelined_fit

__all__ = ["METRIC", "BenchResult", "measure", "main"]

METRIC = "TM8192_minsum_f32_decode_throughput_cuda"
UNIT = "codewords/s/chip"
CODE = "TM8192"
BATCH = 16384
MAXITERS = 50
REPS = 3
BASELINE_FILE = Path(__file__).with_name("bench_baseline.json")


@dataclass(frozen=True)
class BenchResult:
    line: dict  # the JSON line of standard output
    fit: Fit
    batch: int
    card: dict  # `device.describe_card`

    def diagnostics(self) -> dict:
        """The fit and the card, under `bench.py`'s keys (standard error)."""
        f = self.fit
        return {
            "fit_points": [[int(k), round(t, 6)] for k, t in f.points],
            "residuals_s": [round(r, 6) for r in f.residuals],
            "r_squared": round(f.r2, 6),
            "sec_per_dispatch": round(f.slope, 6),
            "amortized_rate_cw_s": round(self.batch * f.amortized, 1),
            "card": self.card["smi"] or self.card["name"],
            "power_limit_w": self.card["power_limit_w"],
        }


def _baseline(device_type: str) -> float | None:
    if device_type != "cuda" or not BASELINE_FILE.exists():
        return None
    return json.loads(BASELINE_FILE.read_text()).get("value")


def measure(batch: int = BATCH, impl: str = "cuda_layered", pipeline: int = 32,
            reps: int = REPS, device="cuda", clock=time.perf_counter) -> BenchResult:
    """Decode the scenario's batch, check that every frame converged, and fit
    the time of trains of up to `pipeline` decodes (`clock` is the wall clock,
    a parameter so that a test can fake it)."""
    dev = resolve_device(device)
    code = get_code(CODE)
    llrs = hard_to_llrs(flipped_codewords(code, batch, dev)[1], torch.float32, dev)
    decoder = _make_decoder(code, torch.float32, MAXITERS, None, impl, dev)
    if not bool(decoder(llrs).success.all()):  # also builds and loads the kernel
        raise RuntimeError("the bench decode must converge on every frame")

    def sync(out):
        out.success[:1].cpu()  # the last decode's first flag: launches run in order

    fit = pipelined_fit(decoder, llrs, sync, k=pipeline, reps=reps, clock=clock)
    rate = fit.rate(batch)
    card = describe_card(dev)
    base = _baseline(dev.type)
    line = {
        "metric": METRIC,
        "value": round(rate, 1),
        "unit": UNIT,
        "vs_baseline": round(rate / base, 3) if base else None,
        "device": card["name"],
    }
    return BenchResult(line, fit, batch, card)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    batch = int(argv[0]) if argv else BATCH
    impl = os.environ.get("BENCH_IMPL", "cuda_layered")
    pipeline = int(os.environ.get("BENCH_PIPELINE", "32"))
    r = measure(batch, impl, pipeline, device="cuda")
    print(json.dumps(r.diagnostics()), file=sys.stderr)
    print(json.dumps(r.line))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
