"""Finds a cell's parts by name and prints its result.

Everything a cell is made of is found through `BENCHMARK.json` at the root
of the checkout: the cell names its configuration and traffic; the
configuration's `file` is `configs/<name>.json`; the traffic is
`traffic/<name>.json`, whose `driver` names a module `drivers/<driver>.py`;
each per-layer metric `<metric>` is a module `metrics/<metric>.py` (loaded
by path, since metric names carry dots). A new cell, configuration, traffic
mix or metric is new files and new entries; no file here changes.

A driver module has `run(ctx) -> Outcome`. A metric module has
`read(trace, counts, config) -> float | None`; None leaves the metric out
of the line.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

__all__ = ["HERE", "FORBIDDEN", "Cell", "Check", "Context", "Outcome", "find_cell",
           "load_metric", "forbidden_loaded", "result_line", "process_age_s", "derive"]

HERE = Path(__file__).resolve().parent
# top-level module names the benchmark's process must never hold
FORBIDDEN = ("jax", "jaxlib", "flax", "labrador_ldpc_tpu")


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict  # the configuration's file, as run
    traffic: dict
    driver: object  # the driver module
    end_to_end: list  # this cell's entries of BENCHMARK.json's end_to_end
    per_layer: list


@dataclass
class Check:
    """One number compared, with its limit: correct while value <= limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclass
class Outcome:
    attempted: int
    failed: int
    metrics: dict  # end-to-end metric name -> value (set-up excluded)
    counts: dict  # what the per-layer metrics read besides the trace
    checks: list  # [Check]
    memory_peak_bytes: int
    trace: object = None  # trace.Trace of a traced run


@dataclass
class Context:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: object  # torch.device
    dry_run: bool = False
    log: object = field(default=sys.stderr)
    window_start: float | None = None  # perf_counter at the window's start
    _t0: float = field(default_factory=time.perf_counter)
    _age0: float = 0.0
    marks: list = field(default_factory=list)  # (label, perf_counter) of set-up's parts

    def mark(self, label: str) -> None:
        """End a named part of set-up."""
        self.marks.append((label, time.perf_counter()))

    def setup_parts(self) -> list:
        """(label, seconds) of set-up's parts, from process start to the window."""
        out, t = [("process start to harness", self._age0)], self._t0
        for label, at in self.marks:
            out.append((label, at - t))
            t = at
        if self.window_start is not None:
            out.append(("rest", self.window_start - t))
        return out

    def window_started(self) -> float:
        """Mark the window's start; returns it (perf_counter)."""
        self.window_start = time.perf_counter()
        return self.window_start

    @property
    def setup_s(self) -> float:
        """From process start to the window's start."""
        return self._age0 + (self.window_start - self._t0)

    def say(self, *args) -> None:
        print(*args, file=self.log, flush=True)


def process_age_s() -> float:
    """Seconds since this process started, from /proc (clock ticks)."""
    try:
        start_ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def _json(path: Path) -> dict:
    with path.open() as f:
        return json.load(f)


def find_cell(name: str, root: Path | None = None) -> Cell:
    root = HERE.parent if root is None else root
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json ({', '.join(sorted(cells))})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _json(root / configs[w["config"]]["file"])
    traffic = _json(HERE / "traffic" / f"{w['traffic']}.json")
    driver = importlib.import_module(f"portbench.drivers.{traffic['driver']}")

    def mine(m):
        return "workloads" not in m or name in m["workloads"]

    return Cell(name, w, config, traffic, driver,
                [m for m in bench["end_to_end"] if mine(m)],
                [m for m in bench["per_layer"] if mine(m)])


def load_metric(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{name}", path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no reader for metric {name!r} at {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_loaded(modules=None) -> list[str]:
    """Top-level names in `modules` (default sys.modules) that are FORBIDDEN,
    compared whole: `labrador_ldpc_tpu_torch` is not `labrador_ldpc_tpu`."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & set(FORBIDDEN))


def result_line(outcome: Outcome, metrics: dict, device: dict, breakdown: dict | None) -> str:
    """The last line: correct, attempted, failed, metrics, device, [breakdown],
    and last the numbers compared with their limits."""
    out = {
        "correct": all(c.ok for c in outcome.checks),
        "attempted": outcome.attempted,
        "failed": outcome.failed,
        "metrics": metrics,
        "device": device,
    }
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in outcome.checks}
    return json.dumps(out)


def derive(seed: int, *keys: int) -> int:
    """A 63-bit seed derived from the run's seed and integer keys."""
    import numpy as np

    return int(np.random.SeedSequence([seed % 2**64, *keys]).generate_state(1, np.uint64)[0] >> 1)
