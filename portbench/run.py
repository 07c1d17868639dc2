"""Run one cell of the port's benchmark and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with an NVIDIA card. Set-up
(imports, CUDA start, the kernels' load, the cell's inputs, warm-up) is
`setup_s`; then the cell's driver measures for `--seconds`, frees the
program's state and has the plain reference judge what the window produced.
`--trace 0` reports the cell's end-to-end metrics, `--trace 1` its
per-layer metrics from a `torch.profiler` trace of the window. The last line
of standard output is one JSON object (`harness.result_line`); the numbers
compared, each with its limit, are also the last lines of standard error.

Without a CUDA card, or with fewer than the cell asks for, it exits 1 and
prints no result; so it does, and names them, where the process holds
`jax`, `jaxlib`, `flax` or `labrador_ldpc_tpu` once the window has closed.
`--dry-run` runs the same code path on the CPU at the traffic file's tiny
`dry_run` sizes with the program's plain versions, for the self-tests only;
it prints no result line either.

Build and kernel caches stay in the checkout at fixed paths: the port's
nvcc builds in `labrador_ldpc_tpu_torch/_build/`, Triton's and PyTorch's
extension caches in `.bench_cache/`.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _environment() -> None:
    cache = ROOT / ".bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ.setdefault("OMP_NUM_THREADS", "4")


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--dry-run", action="store_true",
                    help="CPU, tiny sizes, plain versions: for the self-tests only")
    return ap.parse_args(argv)


def measure(args, log=sys.stderr):
    """Set up, measure and judge one run. Returns (context, outcome, line
    metrics, device record, breakdown)."""
    from .harness import Context, find_cell, load_metric, process_age_s

    age0, t0 = process_age_s(), time.perf_counter()
    cell = find_cell(args.workload)
    import torch

    if args.dry_run:
        device = torch.device("cpu")
    else:
        chips = cell.workload["chips"]
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            have = torch.cuda.device_count() if torch.cuda.is_available() else 0
            raise SystemExit(f"portbench: the cell {cell.name} needs {chips} CUDA card(s), "
                             f"this machine has {have}")
        device = torch.device("cuda", 0)
    ctx = Context(cell, args.seed, args.seconds, bool(args.trace), device, args.dry_run, log)
    ctx._age0, ctx._t0 = age0, t0
    ctx.mark("import torch, read the cell")
    torch.zeros(1, device=device)
    ctx.mark("CUDA context")
    outcome = cell.driver.run(ctx)
    ctx.say("set-up: " + ", ".join(f"{label} {sec:.3f} s" for label, sec in ctx.setup_parts()))

    metrics, breakdown = {}, None
    if not args.trace:
        values = dict(outcome.metrics, setup_s=ctx.setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        t = outcome.trace
        ctx.say(f"trace: window {t.window_s:.3f} s, {len(t.kernels)} kernels, {len(t.copies)} "
                f"copies and sets, device ranges {sorted({r[0] for r in t.ranges})}")
        for m in cell.per_layer:
            value = load_metric(m["name"]).read(outcome.trace, outcome.counts, cell.config)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        breakdown = {"device_ops": outcome.trace.top_ops(10),
                     "idle_gaps": outcome.trace.idle_by_host(10)}
    device = {"platform": "cpu" if args.dry_run else "gpu",
              "kind": "cpu" if args.dry_run else torch.cuda.get_device_name(0),
              "count": cell.workload["chips"],
              "memory_peak_bytes": outcome.memory_peak_bytes}
    if args.trace:
        device["busy_s"] = outcome.trace.busy_s()
        device["window_s"] = outcome.trace.window_s
    return ctx, outcome, metrics, device, breakdown


def power_limit() -> str:
    import subprocess

    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def main(argv=None) -> int:
    _environment()
    args = parse(sys.argv[1:] if argv is None else argv)
    from .harness import forbidden_loaded, result_line

    ctx, outcome, metrics, device, breakdown = measure(args)
    found = forbidden_loaded()
    if found:
        print(f"portbench: the process holds {', '.join(found)} after the window", file=sys.stderr)
        return 1
    if not args.dry_run:
        ctx.say(f"card: {power_limit()}")
    for c in outcome.checks:
        ctx.say(f"check {c.name}: {c.value} (limit {c.limit}) {'ok' if c.ok else 'FAILED'}")
    if args.dry_run:
        return 0
    print(result_line(outcome, metrics, device, breakdown), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
