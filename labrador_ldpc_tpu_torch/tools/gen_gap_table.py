"""The bit-flip vs min-sum gap at FER 1e-3 on all nine codes, on the card.

Counterpart of the JAX package's `tools/gen_gap_table.py`: for each (code,
surface) the Eb/N0 axis is walked in 0.25 dB steps from a high-FER start
until FER drops below the target, then the crossing is log-linearly
interpolated from the bracketing pair (each measured with enough trials for
about 60 frame errors at the target). `cross_db` is the walker that
`gen_bsc_thresholds` and `gen_sp_gap` reuse.

Surfaces per code, each on the port impl bit-exact to its JAX twin:
  ms       min-sum f32, soft AWGN LLRs (impl auto: the layered kernel)
  ms_hard  min-sum f32 on hard-sliced channel output (+-1 LLRs)
  bf       bit-flip on the same hard-sliced channel (the bit-flip kernel)
  sp       flooding sum-product, plain PyTorch (no TPU kernel either)
  ms_flood flooding self-corrected min-sum (cuda_qc: the flooding kernel)

Writes bf_ms_gap_table.csv (one row per code) and bf_ms_gap_points.csv
(every probe) into `--out-dir` (default labrador_ldpc_tpu_torch/results/):

    python -m labrador_ldpc_tpu_torch.tools.gen_gap_table [--codes TC128,...]
        [--target 1e-3] [--device cuda] [--out-dir DIR]
"""

from __future__ import annotations

import argparse
import math
import sys
from functools import partial

from ..channel.waterfall import waterfall
from ..codes.params import get_code
from . import Run, add_run_args, make_run, out_dir, write_table

# start of the walk: the mid-waterfall BER-anchor region per code (FER
# 1e-1..1e-2 there), minus margin
MS_START = {
    "TC128": 1.0, "TC256": 0.8, "TC512": 0.8,
    "TM1280": 2.2, "TM1536": 1.4, "TM2048": 0.8,
    "TM5120": 2.0, "TM6144": 1.2, "TM8192": 0.8,
}

STEP = 0.25
BATCH = 8192

# surface -> (waterfall decoder, impl, maxiters)
SURFACES = {
    "ms": ("ms", "auto", 100),
    "ms_hard": ("ms_hard", "auto", 100),
    "bf": ("bf", "auto", 50),
    "sp": ("ms", "sp", 100),
    "ms_flood": ("ms", "cuda_qc", 100),
}

def fer_at(code, surface, db, trials, points_log, run: Run | None = None):
    """FER of `surface` at `db` over `trials` trials (a multiple of BATCH)."""
    run = run or Run()
    decoder, impl, maxiters = SURFACES[surface]
    (p,) = waterfall(
        code, [db], batch=BATCH, maxiters=maxiters,
        max_bits=trials * get_code(code).k, max_bit_errors=10**9,
        noise_model="ebn0", decoder=decoder, impl=impl, seed=0, device=run.device,
    )
    points_log.append(
        f"{code},{surface},{db},{p.trials},{p.bits},{p.bit_errors},"
        f"{p.ber:.6e},{p.frame_errors},{p.fer:.6e}"
    )
    run.record(f"{code:7} {surface:8} {db:5.2f} dB  FER {p.fer:.3e}", p)
    return p.fer


def cross_db(code, surface, target, points_log, fer_fn=None, start=None,
             advance=None, retreat=None, interp=None):
    """Walk toward the target FER; interpolate the crossing.

    Generic over the sweep axis: `advance(x)` moves toward LOWER FER,
    `retreat(x)` jumps back 4 steps when the start overshot,
    `interp(x0, x1, t)` maps the log-FER crossing fraction t onto the axis.
    Defaults are the additive 0.25 dB Eb/N0 walk."""
    fer_fn = fer_fn or fer_at
    x = (start if start is not None
         else MS_START[code] + (0.0 if surface == "ms" else 1.0))
    advance = advance or (lambda v: v + STEP)
    retreat = retreat or (lambda v: v - 4 * STEP)
    interp = interp or (lambda x0, x1, t: x0 + t * (x1 - x0))
    trials = BATCH  # coarse while FER is large
    last = None
    for _ in range(60):
        # enough trials for ~60 FE at the CURRENT expected magnitude
        fer = fer_fn(code, surface, round(x, 6), trials, points_log)
        if fer < target:
            if last is None:  # started below target: walk back up
                x = retreat(x)
                continue
            (x0, f0) = last
            if fer <= 0.0:
                # no errors observed: re-measure with 8x trials once
                fer = fer_fn(code, surface, round(x, 6), trials * 8, points_log)
                if fer <= 0.0:
                    return x0  # conservative
            t = (math.log(target) - math.log(f0)) / (math.log(fer) - math.log(f0))
            return interp(x0, x, t)
        last = (x, fer)
        x = advance(x)
        # keep >= ~60 expected FE at the NEXT point (assume ~4x drop/step)
        want = int(60 / max(fer / 4.0, target))
        trials = min(max(BATCH, (want // BATCH + 1) * BATCH), 96 * BATCH)
    raise RuntimeError(f"no crossing found for {code}/{surface}")


HEADER = (
    "# BF-vs-MS Eb/N0 gap at FER {t:g}, all nine codes (labrador_ldpc_tpu_torch.tools.\n"
    "# gen_gap_table on {card}; kernels impl=auto; AWGN ebn0 channel, hard surfaces\n"
    "# sliced; adaptive 0.25 dB walk + log-linear crossing; batch 8192, seed 0).\n"
    "# Columns: code,fer_target,bf_db,ms_hard_db,ms_db,delta_total_db,"
    "delta_alg_db,delta_hard_db\n"
)
POINTS_HEADER = (
    "# Probe points behind {table}.\n"
    "# Columns: code,surface,ebn0_db,trials,data_bits,bit_errors,ber,frame_errors,fer\n"
)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--codes", default=None)
    ap.add_argument("--target", type=float, default=1e-3)
    add_run_args(ap)
    args = ap.parse_args(argv)
    codes = args.codes.split(",") if args.codes else list(MS_START)
    out = out_dir(args.out_dir)
    run = make_run(args)
    fer_fn = partial(fer_at, run=run)

    points_log: list[str] = []
    rows = []
    for code in codes:
        res = {}
        for surface in ("ms", "ms_hard", "bf"):
            res[surface] = cross_db(code, surface, args.target, points_log, fer_fn=fer_fn)
        rows.append(
            f"{code},{args.target:g},{res['bf']:.2f},{res['ms_hard']:.2f},"
            f"{res['ms']:.2f},{res['bf'] - res['ms']:.2f},"
            f"{res['bf'] - res['ms_hard']:.2f},"
            f"{res['ms_hard'] - res['ms']:.2f}"
        )
        print(f"{code}: bf {res['bf']:.2f} / ms_hard {res['ms_hard']:.2f} / "
              f"ms {res['ms']:.2f} dB -> total {res['bf']-res['ms']:.2f} = "
              f"alg {res['bf']-res['ms_hard']:.2f} + hard "
              f"{res['ms_hard']-res['ms']:.2f}", flush=True)

    header = HEADER.format(t=args.target, card="{card}")
    write_table(out / "bf_ms_gap_table.csv", header, rows, run, "gen_gap_table", argv)
    write_table(out / "bf_ms_gap_points.csv",
                POINTS_HEADER.format(table="bf_ms_gap_table.csv"), points_log, run,
                "gen_gap_table", argv)
    print(run.summary(), flush=True)


if __name__ == "__main__":
    main()
