"""The min-sum vs sum-product gap at FER 1e-3, on the card.

Counterpart of the JAX package's `tools/gen_sp_gap.py`: walks the FER 1e-3
Eb/N0 crossing (`gen_gap_table.cross_db`) of three decoders on the soft AWGN
channel:

  sp        flooding sum-product, the yardstick (plain PyTorch on the card:
            the JAX package has no kernel for it either)
  ms_flood  flooding self-corrected min-sum (cuda_qc: the flooding kernel)
  ms        the production layered self-corrected min-sum (the layered kernel)

Writes sp_ms_gap.csv and sp_ms_gap_points.csv into `--out-dir` (default
labrador_ldpc_tpu_torch/results/):

    python -m labrador_ldpc_tpu_torch.tools.gen_sp_gap
        [--codes TC128,TC512,TM2048,TM8192] [--device cuda] [--out-dir DIR]
"""

from __future__ import annotations

import argparse
import sys
from functools import partial

from . import add_run_args, make_run, out_dir, write_table
from .gen_gap_table import POINTS_HEADER, cross_db, fer_at

HEADER = (
    "# Min-sum vs sum-product Eb/N0 gap at FER {t:g}\n"
    "# (labrador_ldpc_tpu_torch.tools.gen_sp_gap on {card}; soft AWGN ebn0; adaptive walk;\n"
    "# sp = flooding BP w/ true LLRs, ms_flood = reference flooding SCMS\n"
    "# on the flooding kernel, ms = production layered SCMS; batch 8192,\n"
    "# maxiters 100, seed 0).\n"
    "# Columns: code,fer_target,sp_db,ms_flood_db,ms_db,"
    "delta_flood_db,delta_layered_db\n"
)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--codes", default="TC128,TC512,TM2048,TM8192")
    ap.add_argument("--target", type=float, default=1e-3)
    add_run_args(ap)
    args = ap.parse_args(argv)
    codes = args.codes.split(",")
    out = out_dir(args.out_dir)
    run = make_run(args)
    fer_fn = partial(fer_at, run=run)

    points_log: list[str] = []
    rows = []
    for code in codes:
        res = {}
        for surface in ("sp", "ms_flood", "ms"):
            res[surface] = cross_db(code, surface, args.target, points_log, fer_fn=fer_fn)
        rows.append(
            f"{code},{args.target:g},{res['sp']:.3f},{res['ms_flood']:.3f},"
            f"{res['ms']:.3f},{res['ms_flood'] - res['sp']:.3f},"
            f"{res['ms'] - res['sp']:.3f}"
        )
        print(f"{code}: sp {res['sp']:.3f} / ms_flood {res['ms_flood']:.3f} "
              f"/ ms {res['ms']:.3f} dB -> flood-vs-sp "
              f"{res['ms_flood'] - res['sp']:+.3f} dB, layered-vs-sp "
              f"{res['ms'] - res['sp']:+.3f} dB", flush=True)

    header = HEADER.format(t=args.target, card="{card}")
    write_table(out / "sp_ms_gap.csv", header, rows, run, "gen_sp_gap", argv)
    write_table(out / "sp_ms_gap_points.csv", POINTS_HEADER.format(table="sp_ms_gap.csv"),
                points_log, run, "gen_sp_gap", argv)
    print(run.summary(), flush=True)


if __name__ == "__main__":
    main()
