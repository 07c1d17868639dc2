"""Hold the card's quality tables to the TPU's, by a stated statistic.

    python -m labrador_ldpc_tpu_torch.tools.compare [--card-dir DIR] [--tpu-dir DIR]

Pairs every table of the five generators (`tables`) in `--card-dir`
(default labrador_ldpc_tpu_torch/results/) with the TPU table of the same
name in `--tpu-dir` (default benchmarks/results/), both read by
`read_table`, and tests:

- Points with frame errors: a row of each file with the same (code,
  surface or noise model, axis value) form a pair (a walk that probed a
  point twice keeps its deeper row). Under equal FER, given E = e_card +
  e_tpu frame errors, e_card ~ Binomial(E, n_card / (n_card + n_tpu)) (the
  conditional test of two Poisson rates); a pair fails at a two-sided
  p < P_FAIL. A pair where both sides have fewer than MIN_ERRORS frame
  errors is printed and not gated (the TPU keeps such tail rows for curve
  shape only). BER is not compared: the bits of one frame are not
  independent.
- Crossings (bf_ms_gap_table.csv, sp_ms_gap.csv, bsc_thresholds.csv): each
  dB crossing within DB_BOUND of the TPU's, each p* within |ln(p*_card /
  p*_tpu)| <= LN_P_BOUND. Each crossing is interpolated between probes
  with at least about 60 frame errors (about 13 % spread in FER); over a
  0.25 dB step, or a 0.82x step in p, with a FER drop of 4x or more, two
  independent runs differ with about 0.045 dB, or 0.027 in ln p, of spread:
  both bounds are about 3.3 of those.

The bounds are fixed here, for every row. One line a pair, then a summary;
the exit code is 1 if a pair failed, 2 if there was nothing to compare.
"""

from __future__ import annotations

import argparse
import math
import sys
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from . import RESULTS, TPU_RESULTS, gen_ber_anchors
from .gen_bf_curves import jobs

P_FAIL = 1e-5
MIN_ERRORS = 20
DB_BOUND = 0.15
LN_P_BOUND = 0.10

# columns that are counts or statistics; the others key a row
_COUNTS = {"trials", "data_bits", "bit_errors", "ber", "frame_errors", "fer"}


def tables() -> list[str]:
    """The names of the tables the five generators write."""
    a = gen_ber_anchors
    return [a.OUT, a.OUT_I8, a.OUT_I16, a.OUT_I8_FLOOD, a.OUT_I16_FLOOD, a.OUT_SP,
            *(job[6] for job in jobs(True)), "bf_ms_gap_table.csv", "bf_ms_gap_points.csv",
            "bsc_thresholds.csv", "bsc_threshold_points.csv", "sp_ms_gap.csv",
            "sp_ms_gap_points.csv"]


def read_table(path) -> tuple[list[str], list[list[str]]]:
    """(columns, rows) of a results table: the columns from its `# Columns:`
    line, the rows from its other lines that are not comments."""
    columns, rows = None, []
    for line in Path(path).read_text().splitlines():
        if line.startswith("# Columns:"):
            columns = [c.strip() for c in line.split(":", 1)[1].split(",")]
        elif line.strip() and not line.startswith("#"):
            rows.append([f.strip() for f in line.split(",")])
    if columns is None:
        raise ValueError(f"{path}: no '# Columns:' line")
    return columns, rows


def _key_value(v: str):
    try:
        return float(f"{float(v):.9g}")
    except ValueError:
        return v


def binom_two_sided(k: int, n: int, p: float) -> float:
    """Two-sided p-value of k successes in n Binomial(n, p) trials: twice
    the smaller tail, at most 1."""
    if n == 0:
        return 1.0
    i = np.arange(1, n + 1, dtype=np.float64)
    log_choose = np.concatenate([[0.0], np.cumsum(np.log((n - i + 1) / i))])
    j = np.arange(n + 1, dtype=np.float64)
    log_pmf = log_choose + j * math.log(p) + (n - j) * math.log1p(-p)

    def log_sum(x):
        m = x.max()
        return m + math.log(np.exp(x - m).sum())

    tail = min(log_sum(log_pmf[: k + 1]), log_sum(log_pmf[k:]))
    return min(1.0, 2.0 * math.exp(tail))


def rate_test(e_card: int, n_card: int, e_tpu: int, n_tpu: int) -> float:
    """p-value of equal frame-error rates: e_card given the E = e_card +
    e_tpu errors, Binomial(E, n_card / (n_card + n_tpu))."""
    return binom_two_sided(e_card, e_card + e_tpu, n_card / (n_card + n_tpu))


@dataclass
class Pair:
    file: str
    key: str
    kind: str  # "fer", "db" or "p"
    text: str
    gated: bool
    ok: bool

    def line(self) -> str:
        mark = ("PASS" if self.ok else "FAIL") if self.gated else "----"
        return f"{mark} {self.file} {self.key} [{self.kind}] {self.text}"


def _points_pairs(name, cols, card_rows, tpu_rows) -> tuple[list[Pair], int]:
    key_cols = [i for i, c in enumerate(cols) if c not in _COUNTS]
    t_i, e_i = cols.index("trials"), cols.index("frame_errors")

    def by_key(rows):
        out = {}
        for r in rows:
            key = tuple(_key_value(r[i]) for i in key_cols)
            if key not in out or int(r[t_i]) >= int(out[key][t_i]):
                out[key] = r
        return out

    card, tpu = by_key(card_rows), by_key(tpu_rows)
    pairs = []
    for key, c in card.items():
        if key not in tpu:
            continue
        t = tpu[key]
        n_c, e_c, n_t, e_t = int(c[t_i]), int(c[e_i]), int(t[t_i]), int(t[e_i])
        gated = max(e_c, e_t) >= MIN_ERRORS
        p = rate_test(e_c, n_c, e_t, n_t)
        ratio = (e_c / n_c) / (e_t / n_t) if e_t else float("inf") if e_c else 1.0
        text = (f"card {e_c}/{n_c} tpu {e_t}/{n_t} FER ratio {ratio:.3f} p={p:.3g}"
                + ("" if gated else f" (both under {MIN_ERRORS} errors)"))
        pairs.append(Pair(name, "/".join(str(k) for k in key), "fer", text, gated,
                          p >= P_FAIL))
    return pairs, len(card) - sum(1 for k in card if k in tpu)


def _crossing_pairs(name, cols, card_rows, tpu_rows) -> tuple[list[Pair], int]:
    key_cols = [cols.index("code"), cols.index("fer_target")]
    tpu = {tuple(_key_value(r[i]) for i in key_cols): r for r in tpu_rows}
    pairs, unpaired = [], 0
    for c in card_rows:
        key = tuple(_key_value(c[i]) for i in key_cols)
        if key not in tpu:
            unpaired += 1
            continue
        t = tpu[key]
        pairs += [crossing(name, key[0], col, float(c[i]), float(t[i]))
                  for i, col in enumerate(cols)
                  if (col.endswith("_db") and not col.startswith("delta"))
                  or col.startswith("p_star")]
    return pairs, unpaired


def crossing(name, code, col, card: float, tpu: float) -> Pair:
    """The pair of one crossing: a dB column (`*_db`) within DB_BOUND, a p*
    column (`p_star*`) within LN_P_BOUND in ln p."""
    if col.startswith("p_star"):
        d = math.log(card / tpu)
        return Pair(name, f"{code}/{col}", "p",
                    f"card {card:.6g} tpu {tpu:.6g} ln ratio {d:+.4f} (bound {LN_P_BOUND})",
                    True, abs(d) <= LN_P_BOUND)
    d = card - tpu
    return Pair(name, f"{code}/{col}", "db",
                f"card {card:.3f} tpu {tpu:.3f} diff {d:+.3f} dB (bound {DB_BOUND})",
                True, abs(d) <= DB_BOUND)


def compare_files(card_path, tpu_path) -> tuple[list[Pair], int]:
    """The pairs of one card table and its TPU table, and the card rows
    without a TPU row."""
    cols, card_rows = read_table(card_path)
    tpu_cols, tpu_rows = read_table(tpu_path)
    name = Path(card_path).name
    if cols != tpu_cols:
        raise ValueError(f"{name}: card columns {cols} differ from the TPU's {tpu_cols}")
    if "fer_target" in cols:
        return _crossing_pairs(name, cols, card_rows, tpu_rows)
    return _points_pairs(name, cols, card_rows, tpu_rows)


def compare_dirs(card_dir, tpu_dir) -> tuple[list[Pair], list[str], int]:
    """Every pair of the generators' tables (`tables`) in `card_dir` that
    have a TPU table of the same name: (pairs, the files compared, card rows
    without a TPU row)."""
    files = [name for name in tables()
             if (Path(card_dir) / name).exists() and (Path(tpu_dir) / name).exists()]
    pairs, unpaired = [], 0
    for name in files:
        got, missing = compare_files(Path(card_dir) / name, Path(tpu_dir) / name)
        pairs += got
        unpaired += missing
    return pairs, files, unpaired


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--card-dir", type=Path, default=RESULTS)
    ap.add_argument("--tpu-dir", type=Path, default=TPU_RESULTS)
    args = ap.parse_args(argv)
    pairs, files, unpaired = compare_dirs(args.card_dir, args.tpu_dir)
    for p in pairs:
        print(p.line())
    gated = [p for p in pairs if p.gated]
    failed = [p for p in gated if not p.ok]
    kinds = {k: sum(1 for p in gated if p.kind == k) for k in ("fer", "db", "p")}
    print(f"compare: {len(files)} files; {len(gated)} gated pairs ({kinds['fer']} points, "
          f"{kinds['db']} dB crossings, {kinds['p']} p* crossings), "
          f"{len(gated) - len(failed)} passed, {len(failed)} failed; "
          f"{len(pairs) - len(gated)} ungated; {unpaired} card rows without a TPU row "
          f"(p < {P_FAIL:g} fails a point; crossings within {DB_BOUND} dB, |ln p| <= "
          f"{LN_P_BOUND})", flush=True)
    if not pairs:
        print(f"compare: nothing to compare in {args.card_dir}", file=sys.stderr)
        return 2
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
