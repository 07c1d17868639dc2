"""The code-quality generators on the card, and the comparison with the TPU's tables.

Counterparts of the JAX package's `tools/gen_ber_anchors.py`,
`gen_bf_curves.py`, `gen_gap_table.py`, `gen_bsc_thresholds.py` and
`gen_sp_gap.py`, each a module here with its twin's job list, budgets, seed
and walk, driving the port's `channel.waterfall.waterfall` (on the card unless
`--device cpu`). Each JAX impl maps to the port impl that is bit-exact to the
same twin on a card: `qc`/`pallas_qc` -> `cuda_qc` (the flooding kernel; the
port's `qc` is the plain flooding decoder), `pallas_layered` ->
`cuda_layered`, `sp_pallas` -> `cuda_sp`; `auto` and `sp` stay as they are.

The tables keep the TPU's file names and columns and go to `RESULTS`
(`labrador_ldpc_tpu_torch/results/`) or `--out-dir`, never to the repo's
`benchmarks/results/`, which holds the TPU's record (`out_dir` raises).
`python -m labrador_ldpc_tpu_torch.tools.compare` holds each file to the
TPU file of the same name.
"""

from __future__ import annotations

import shlex
import time
from dataclasses import dataclass, field
from pathlib import Path

from ..device import describe_card, resolve_device

__all__ = ["RESULTS", "TPU_RESULTS", "Run", "out_dir", "write_table"]

RESULTS = Path(__file__).resolve().parents[1] / "results"
TPU_RESULTS = Path(__file__).resolve().parents[2] / "benchmarks" / "results"


@dataclass
class Run:
    """A generator's run: its device, its start on the host clock, and the
    points it measured, (label, SnrPoint), for the summary of the deepest one."""

    device: str = "cuda"
    points: list = field(default_factory=list)
    t0: float = field(default_factory=time.perf_counter)

    def record(self, label: str, pt) -> None:
        self.points.append((label, pt))
        print(f"  {label}  {pt.frame_errors}/{pt.trials} frames  "
              f"{pt.trials / max(pt.elapsed_s, 1e-9):,.0f} cw/s", flush=True)

    def summary(self) -> str:
        """The run's wall, and the deepest point (most trials) with its cw/s."""
        wall = time.perf_counter() - self.t0
        line = f"wall {wall:.1f} s"
        if self.points:
            label, pt = max(self.points, key=lambda lp: lp[1].trials)
            line += (f"; deepest point {label}: {pt.trials} trials in {pt.elapsed_s:.3f} s, "
                     f"{pt.trials / max(pt.elapsed_s, 1e-9):,.0f} cw/s")
        return line


def add_run_args(ap) -> None:
    """The arguments every generator takes."""
    ap.add_argument("--device", default="cuda", help="'cpu' runs the plain versions")
    ap.add_argument("--out-dir", type=Path, default=RESULTS,
                    help="where the tables go (never benchmarks/results, the TPU's record)")


def make_run(args) -> Run:
    return Run(device=str(resolve_device(args.device)))


def out_dir(path) -> Path:
    """`path`, created; raises for the repo's benchmarks/results (or any
    directory `results` inside one named `benchmarks`): that is the TPU's record."""
    path = Path(path).resolve()
    if path.parts[-2:] == ("benchmarks", "results"):
        raise ValueError(f"{path} holds the TPU's tables; the port writes its own "
                         f"(default {RESULTS})")
    path.mkdir(parents=True, exist_ok=True)
    return path


def write_table(path: Path, header: str, rows: list[str], run: Run, module: str,
                argv: list[str]) -> None:
    """Write `rows` under `header` (the TPU's, with the card, `{card}`, for
    "real TPU"), adding before its Columns line the command (without its
    --out-dir: a table is read where it lies) and the run's wall."""
    card = describe_card(run.device)
    args = [a for i, a in enumerate(argv)
            if not a.startswith("--out-dir") and (i == 0 or argv[i - 1] != "--out-dir")]
    extra = [f"# command: python -m labrador_ldpc_tpu_torch.tools.{module} "
             f"{shlex.join(args)}".rstrip(),
             f"# {run.summary()}"]
    lines = header.replace("{card}", card["smi"] or card["name"]).splitlines()
    at = next(i for i, line in enumerate(lines) if line.startswith("# Columns:"))
    lines[at:at] = extra
    path.write_text("\n".join(lines) + "\n" + "\n".join(rows) + "\n")
    print(f"wrote {len(rows)} rows to {path}", flush=True)
