"""BSC operating points of the hard-decision decoders, all nine codes, on the card.

Counterpart of the JAX package's `tools/gen_bsc_thresholds.py`: for each
code, the flip probability p* where FER crosses 1e-3 on BSC(p) for both
hard-input surfaces, bf (Gallager bit-flip, the bit-flip kernel) and ms_hard
(min-sum over +-1 LLRs from the same flipped bits, the layered kernel). The
walk is `gen_gap_table.cross_db` on a multiplicative axis (p shrinks 0.82x a
step from a high-FER start) with log-log interpolation of the crossing;
seed 0, batch 8192, maxiters 50 (bf) / 100 (ms_hard).

Writes bsc_thresholds.csv and bsc_threshold_points.csv into `--out-dir`
(default labrador_ldpc_tpu_torch/results/):

    python -m labrador_ldpc_tpu_torch.tools.gen_bsc_thresholds [--codes ...]
        [--target 1e-3] [--device cuda] [--out-dir DIR]
"""

from __future__ import annotations

import argparse
import math
import sys
from functools import partial

from ..channel.waterfall import waterfall
from . import Run, add_run_args, make_run, out_dir, write_table
from .gen_gap_table import cross_db

# high-FER starting p per code (bf first, ms_hard scales up ~2-4x);
# coarse is fine: the walk self-corrects
P_START_BF = {
    "TC128": 0.03, "TC256": 0.03, "TC512": 0.03,
    "TM1280": 0.01, "TM1536": 0.012, "TM2048": 0.01,
    "TM5120": 0.006, "TM6144": 0.006, "TM8192": 0.005,
}

BATCH = 8192
SHRINK = 0.82
K = {"TC128": 64, "TC256": 128, "TC512": 256, "TM1280": 1024,
     "TM1536": 1024, "TM2048": 1024, "TM5120": 4096, "TM6144": 4096,
     "TM8192": 4096}


def fer_at(code, surface, p, trials, points_log, run: Run | None = None):
    """FER of `surface` on BSC(p) over `trials` trials."""
    run = run or Run()
    maxiters = 50 if surface == "bf" else 100
    (pt,) = waterfall(
        code, [p], batch=BATCH, maxiters=maxiters,
        max_bits=trials * K[code], max_bit_errors=10**9,
        noise_model="bsc", decoder=surface, seed=0, device=run.device,
    )
    points_log.append(
        f"{code},{surface},{p:.6g},{pt.trials},{pt.bits},{pt.bit_errors},"
        f"{pt.ber:.6e},{pt.frame_errors},{pt.fer:.6e}"
    )
    run.record(f"{code:7} {surface:8} p={p:.5f}  FER {pt.fer:.3e}", pt)
    return pt.fer


def cross_p(code, surface, target, points_log, run: Run | None = None):
    """The walker (`gen_gap_table.cross_db`) on a multiplicative p axis with
    log-x interpolation."""
    run = run or Run()
    return cross_db(
        code, surface, target, points_log,
        fer_fn=partial(fer_at, run=run),
        start=P_START_BF[code] * (3.0 if surface == "ms_hard" else 1.0),
        advance=lambda x: x * SHRINK,
        retreat=lambda x: x / SHRINK**4,
        interp=lambda x0, x1, t: math.exp(
            math.log(x0) + t * (math.log(x1) - math.log(x0))
        ),
    )


HEADER = (
    "# BSC flip-probability operating points at FER {t:g}, all nine codes\n"
    "# (labrador_ldpc_tpu_torch.tools.gen_bsc_thresholds on {card};\n"
    "# kernels impl=auto; multiplicative walk + log-log crossing; batch 8192, seed 0,\n"
    "# maxiters 50 bf / 100 ms_hard).\n"
    "# Columns: code,fer_target,p_star_bf,p_star_ms_hard,ratio\n"
)
POINTS_HEADER = (
    "# Probe points behind bsc_thresholds.csv.\n"
    "# Columns: code,surface,p,trials,data_bits,bit_errors,ber,frame_errors,fer\n"
)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--codes", default=None)
    ap.add_argument("--target", type=float, default=1e-3)
    add_run_args(ap)
    args = ap.parse_args(argv)
    codes = args.codes.split(",") if args.codes else list(P_START_BF)
    out = out_dir(args.out_dir)
    run = make_run(args)

    points_log: list[str] = []
    rows = []
    for code in codes:
        p_bf = cross_p(code, "bf", args.target, points_log, run)
        p_mh = cross_p(code, "ms_hard", args.target, points_log, run)
        rows.append(f"{code},{args.target:g},{p_bf:.6g},{p_mh:.6g},"
                    f"{p_mh / p_bf:.2f}")
        print(f"{code}: p*(bf) {p_bf:.5f}  p*(ms_hard) {p_mh:.5f}  "
              f"ratio {p_mh / p_bf:.2f}x", flush=True)

    header = HEADER.format(t=args.target, card="{card}")
    write_table(out / "bsc_thresholds.csv", header, rows, run, "gen_bsc_thresholds", argv)
    write_table(out / "bsc_threshold_points.csv", POINTS_HEADER, points_log, run,
                "gen_bsc_thresholds", argv)
    print(run.summary(), flush=True)


if __name__ == "__main__":
    main()
