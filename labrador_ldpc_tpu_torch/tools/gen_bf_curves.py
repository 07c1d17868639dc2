"""The deep bit-flip curves and their min-sum references, on the card.

Counterpart of the JAX package's `tools/gen_bf_curves.py`, with its job list
and trial budgets (impl auto: the bit-flip kernel for bf, the layered kernel
for ms and ms_hard):

  1. BSC(p) FER/BER curves of bit-flip, TC512 and TM8192;
  2. AWGN hard-decision (ebn0) FER curves of bit-flip for the same codes;
  3. min-sum ebn0 reference curves (soft, TC512 and TM8192);
  4. BEC(f) curves of bit-flip on the six TM codes (the erasure pass);
  5. min-sum on hard-sliced channel output (ms_hard), TC512 and TM8192.

Then prints the dB between the bf, ms and ms_hard curves at FER 1e-3 and
1e-4 (log-linear interpolation). Each curve goes to its file
(waterfall_*.csv) in `--out-dir` (default labrador_ldpc_tpu_torch/results/):

    python -m labrador_ldpc_tpu_torch.tools.gen_bf_curves [--quick] [--only SUBSTR]
        [--device cuda] [--out-dir DIR]
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import sys
import time

from ..channel.waterfall import waterfall
from ..codes.params import get_code
from . import Run, add_run_args, make_run, out_dir, write_table

BATCH = 8192

HEADER = (
    "# {title}\n"
    "# labrador_ldpc_tpu_torch.tools.gen_bf_curves on {{card}}; decoder={decoder} impl=auto\n"
    "# (CUDA kernels), maxiters={maxiters}, batch=8192, seed 0.\n"
    "# Columns: code,{xname},trials,data_bits,bit_errors,ber,frame_errors,fer\n"
)


def run_curve(code, xs, trials_per_point, decoder, noise_model, maxiters, out,
              title, xname, run: Run, argv):
    """One curve: a waterfall call per point at its trial budget, written to
    `out` with the curve's own wall; its points are added to `run`'s."""
    curve = dataclasses.replace(run, points=[], t0=time.perf_counter())
    rows = []
    k = get_code(code).k
    for x, tp in zip(xs, trials_per_point):
        (p,) = waterfall(
            code, [x], batch=BATCH, maxiters=maxiters,
            max_bits=tp * k, max_bit_errors=10**9,
            noise_model=noise_model, decoder=decoder, seed=0, verbose=True,
            device=run.device,
        )
        curve.record(f"{code} {decoder} {noise_model} {x}", p)
        rows.append(
            f"{code},{x},{p.trials},{p.bits},{p.bit_errors},{p.ber:.6e},"
            f"{p.frame_errors},{p.fer:.6e}"
        )
    header = HEADER.format(title=title, decoder=decoder, maxiters=maxiters, xname=xname)
    write_table(out, header, rows, curve, "gen_bf_curves", argv)
    run.points += curve.points


def read_fer(path):
    """(x, FER) of each row of a curve file."""
    pts = []
    for line in path.read_text().splitlines():
        if line.startswith("#") or not line.strip():
            continue
        f = line.split(",")
        pts.append((float(f[1]), float(f[7])))
    return pts


def db_at_fer(pts, target):
    """log-linear interpolation of the dB (or p) where FER crosses target
    (handles FER falling with x, dB axes, or rising, BSC/BEC p axes)."""
    pts = sorted(pts)
    for (x0, f0), (x1, f1) in zip(pts, pts[1:]):
        if (f0 >= target >= f1 or f0 <= target <= f1) and f0 > 0 and f1 > 0 \
                and f0 != f1:
            t = (math.log(target) - math.log(f0)) / (math.log(f1) - math.log(f0))
            return x0 + t * (x1 - x0)
    return None


def jobs(deep: bool) -> list[tuple]:
    """(code, xs, trials a point, decoder, noise model, maxiters, file, title,
    x name): the JAX tool's job list; `deep` False is its --quick."""
    T = BATCH  # one batch
    d = 1 if deep else 0
    return [
        # BSC(p) on the kernels
        ("TC512", [0.005, 0.01, 0.015, 0.02, 0.025, 0.03, 0.04],
         [T * (64 if d else 1), T * (16 if d else 1),
          T * (8 if d else 1), T * (4 if d else 1), T * 2, T, T],
         "bf", "bsc", 50, "waterfall_bf_tc512_bsc.csv",
         "Bit-flip FER/BER vs BSC flip probability p, TC512", "p"),
        ("TM8192", [0.001, 0.0015, 0.002, 0.003, 0.004, 0.005, 0.006],
         [T * (96 if d else 1), T * (48 if d else 1),
          T * (24 if d else 1), T * (4 if d else 1), T * 2, T, T],
         "bf", "bsc", 50, "waterfall_bf_tm8192_bsc.csv",
         "Bit-flip FER/BER vs BSC flip probability p, TM8192", "p"),
        # AWGN hard-decision, ebn0 axis (the ms-comparable curves)
        ("TC512", [3.0, 3.5, 4.0, 4.5, 5.0, 5.5, 6.0, 6.5, 7.0, 7.5],
         [T, T, T, T, T * 2, T * (4 if d else 1),
          T * (16 if d else 1), T * (48 if d else 1),
          T * (96 if d else 1), T * (192 if d else 1)],
         "bf", "ebn0", 50, "waterfall_bf_tc512_ebn0.csv",
         "Bit-flip FER vs Eb/N0 (AWGN hard-decision), TC512", "ebn0_db"),
        ("TM8192", [4.0, 5.0, 6.0, 6.5, 7.0, 7.5, 8.0, 8.5, 9.0, 9.5],
         [T, T, T, T, T * 2, T * 2, T * (4 if d else 1),
          T * (8 if d else 1), T * (24 if d else 1),
          T * (96 if d else 1)],
         "bf", "ebn0", 50, "waterfall_bf_tm8192_ebn0.csv",
         "Bit-flip FER vs Eb/N0 (AWGN hard-decision), TM8192", "ebn0_db"),
        # min-sum ebn0 references (soft channel, same dB axis, with FER)
        ("TC512", [1.0, 1.5, 2.0, 2.5, 3.0, 3.5],
         [T, T, T * 2, T * (8 if d else 1), T * (48 if d else 1),
          T * (96 if d else 1)],
         "ms", "ebn0", 100, "waterfall_ms_tc512_ebn0.csv",
         "Min-sum f32 FER vs Eb/N0 (soft), TC512 (cuda_layered)", "ebn0_db"),
        ("TM8192", [1.0, 1.1, 1.2, 1.3, 1.4],
         [T, T, T * 2, T * (16 if d else 1), T * (96 if d else 1)],
         "ms", "ebn0", 100, "waterfall_ms_tm8192_ebn0.csv",
         "Min-sum f32 FER vs Eb/N0 (soft), TM8192 (cuda_layered)", "ebn0_db"),
        # BEC erasure-channel sweeps on the bf surface: each transmitted bit
        # erased to 0 i.i.d. w.p. f; the erasure pass handles the punctured
        # tail on top. BEC(f) behaves like BSC(f/2) for this decoder, so each
        # grid sits at about 2x the code's BSC knee
        ("TM1280", [0.002, 0.004, 0.006, 0.008, 0.01, 0.015],
         [T * (48 if d else 1), T * (16 if d else 1),
          T * (4 if d else 1), T * 2, T, T],
         "bf", "bec", 50, "waterfall_bf_tm1280_bec.csv",
         "Bit-flip FER/BER vs BEC erasure probability f, TM1280", "f"),
        ("TM8192", [0.002, 0.003, 0.004, 0.006, 0.008, 0.012],
         [T * (96 if d else 1), T * (48 if d else 1),
          T * (24 if d else 1), T * (4 if d else 1), T * 2, T],
         "bf", "bec", 50, "waterfall_bf_tm8192_bec.csv",
         "Bit-flip FER/BER vs BEC erasure probability f, TM8192", "f"),
        ("TM1536", [0.003, 0.005, 0.008, 0.012, 0.018, 0.025],
         [T * (48 if d else 1), T * (16 if d else 1),
          T * (4 if d else 1), T * 2, T, T],
         "bf", "bec", 50, "waterfall_bf_tm1536_bec.csv",
         "Bit-flip FER/BER vs BEC erasure probability f, TM1536", "f"),
        ("TM2048", [0.003, 0.005, 0.008, 0.012, 0.018, 0.025],
         [T * (48 if d else 1), T * (16 if d else 1),
          T * (4 if d else 1), T * 2, T, T],
         "bf", "bec", 50, "waterfall_bf_tm2048_bec.csv",
         "Bit-flip FER/BER vs BEC erasure probability f, TM2048", "f"),
        ("TM5120", [0.002, 0.003, 0.005, 0.008, 0.011, 0.015],
         [T * (48 if d else 1), T * (24 if d else 1),
          T * (8 if d else 1), T * 2, T, T],
         "bf", "bec", 50, "waterfall_bf_tm5120_bec.csv",
         "Bit-flip FER/BER vs BEC erasure probability f, TM5120", "f"),
        ("TM6144", [0.002, 0.003, 0.005, 0.008, 0.011, 0.015],
         [T * (48 if d else 1), T * (24 if d else 1),
          T * (8 if d else 1), T * 2, T, T],
         "bf", "bec", 50, "waterfall_bf_tm6144_bec.csv",
         "Bit-flip FER/BER vs BEC erasure probability f, TM6144", "f"),
        # min-sum on HARD-sliced channel output: bf minus this curve is the
        # algorithmic gap with the soft-information loss separated out
        ("TC512", [3.5, 4.0, 4.25, 4.5, 4.75, 5.0, 5.25],
         [T, T, T, T * 2, T * (8 if d else 1), T * (24 if d else 1),
          T * (96 if d else 1)],
         "ms_hard", "ebn0", 100, "waterfall_mshard_tc512_ebn0.csv",
         "Min-sum f32 FER vs Eb/N0 (hard-decision input), TC512", "ebn0_db"),
        ("TM8192", [2.5, 2.6, 2.7, 2.8, 2.9, 3.0],
         [T, T, T, T * 2, T * (8 if d else 1), T * (48 if d else 1)],
         "ms_hard", "ebn0", 100, "waterfall_mshard_tm8192_ebn0.csv",
         "Min-sum f32 FER vs Eb/N0 (hard-decision input), TM8192", "ebn0_db"),
    ]


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--quick", action="store_true", help="coarse grids, 8192 trials/point")
    ap.add_argument("--only", default=None, help="substring filter on the output csv name")
    add_run_args(ap)
    args = ap.parse_args(argv)
    out = out_dir(args.out_dir)
    run = make_run(args)
    for code, xs, tps, decoder, model, maxiters, name, title, xname in jobs(not args.quick):
        if args.only and args.only not in name:
            continue
        run_curve(code, xs, tps, decoder, model, maxiters, out / name, title, xname, run, argv)

    print("\n=== BF-vs-MS gap (AWGN, equal Eb/N0 axis) ===")
    for code in ("TC512", "TM8192"):
        curves = {s: out / f"waterfall_{s}_{code.lower()}_ebn0.csv"
                  for s in ("bf", "ms", "mshard")}
        pts = {s: read_fer(p) if p.exists() else [] for s, p in curves.items()}
        for target in (1e-3, 1e-4):
            b, m, h = (db_at_fer(pts[s], target) for s in ("bf", "ms", "mshard"))
            if b is not None and m is not None:
                print(f"{code}: FER {target:g} at bf {b:.2f} dB vs ms "
                      f"{m:.2f} dB -> delta(total) = {b - m:.2f} dB")
                if h is not None:
                    print(f"{code}:   = algorithmic (bf - ms_hard) "
                          f"{b - h:.2f} dB + hard-slice (ms_hard - ms) "
                          f"{h - m:.2f} dB")
            else:
                print(f"{code}: FER {target:g} not bracketed "
                      f"(bf={b}, ms={m}, ms_hard={h})")
    print(run.summary(), flush=True)


if __name__ == "__main__":
    main()
