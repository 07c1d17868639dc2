"""The BER anchors of the nine codes, on the card.

Counterpart of the JAX package's `tools/gen_ber_anchors.py`. Per code,
three anchor points spanning the mid-waterfall (BER about 5e-2 .. 1e-3),
each stopped at 5000 bit errors or 16M data bits; the flooding min-sum
kernel (cuda_qc, the JAX tool's `qc`), f32, maxiters 100, batch 4096. The
switches write the other anchors:

  --i8, --i16                   the layered int path (cuda_layered, default
                                llr_scale), TM8192 1.1 dB and TC512 1.0 dB
  --i8-flooding, --i16-flooding the flooding int path (cuda_qc), TM8192
                                1.1 dB, 8192 trials
  --sp                          layered sum-product (cuda_sp), TM8192 0.9 dB,
                                8192 trials

Each writes its file (ber_regression_points[_i8|_i16|_i8_flooding|
_i16_flooding|_sp].csv) into `--out-dir` (default
labrador_ldpc_tpu_torch/results/):

    python -m labrador_ldpc_tpu_torch.tools.gen_ber_anchors [--i8|...|--sp]
        [--device cuda] [--out-dir DIR]
"""

from __future__ import annotations

import argparse
import sys

from ..channel.waterfall import waterfall
from . import Run, add_run_args, make_run, out_dir, write_table

# (code, noise_model, snr list): the mid-waterfall regions of the JAX tool
GRID = [
    ("TC128", "perftest", [1.2, 1.6, 2.0]),
    ("TC256", "perftest", [1.0, 1.4, 1.8]),
    ("TC512", "perftest", [1.0, 1.2, 1.3]),
    ("TM1280", "ebn0", [2.4, 2.8, 3.2]),
    ("TM1536", "ebn0", [1.6, 2.0, 2.4]),
    ("TM2048", "ebn0", [1.0, 1.4, 1.8]),
    ("TM5120", "ebn0", [2.2, 2.6, 3.0]),
    ("TM6144", "ebn0", [1.4, 1.8, 2.0]),
    ("TM8192", "ebn0", [0.9, 1.1, 1.2]),
]

BATCH = 4096
OUT = "ber_regression_points.csv"
OUT_I8 = "ber_regression_points_i8.csv"
OUT_I8_FLOOD = "ber_regression_points_i8_flooding.csv"
OUT_I16 = "ber_regression_points_i16.csv"
OUT_I16_FLOOD = "ber_regression_points_i16_flooding.csv"
OUT_SP = "ber_regression_points_sp.csv"

COLUMNS = "# Columns: code,snr_db,trials,data_bits,bit_errors,ber,noise_model,frame_errors\n"


def _points(run: Run, code, snrs, model, max_bits, max_bit_errors, **kw):
    pts = waterfall(
        code, snrs, batch=BATCH, maxiters=100,
        max_bits=max_bits, max_bit_errors=max_bit_errors,
        noise_model=model, seed=0, verbose=True, device=run.device, **kw,
    )
    for p in pts:
        run.record(f"{code} {p.snr_db} {model}", p)
    return [f"{p.csv()},{model},{p.frame_errors}" for p in pts]


def anchors(run: Run, out, argv, grid=GRID):
    """The f32 anchors of `grid` (the JAX tool's `main`)."""
    rows = []
    for code, model, snrs in grid:
        rows += _points(run, code, snrs, model, 16_000_000, 5_000, impl="cuda_qc")
    header = (
        "# BER anchors measured on {card}\n"
        "# (labrador_ldpc_tpu_torch.tools.gen_ber_anchors; impl=cuda_qc\n"
        "# f32, maxiters=100, batch=4096, stop at 5k bit errors or 16M data\n"
        "# bits, seed 0).\n"
        + COLUMNS +
        "# Rows whose frame_errors are too few for a reduced-budget CI rerun\n"
        "# to expect >=70 are waterfall-TAIL measurements kept for curve shape\n"
        "# only and MUST NOT be used as regression gates (the reference's own\n"
        "# stopping rule is 5k errors, perftest/src/main.rs:50).\n"
    )
    write_table(out / OUT, header, rows, run, "gen_ber_anchors", argv)
    return out / OUT


def main_int(bits: int, flooding: bool, run: Run, out, argv):
    """An integer-LLR path at its anchor points: layered (`--i8`/`--i16`,
    impl cuda_layered, default quantizer scale: 16 for int8, 256 for int16)
    at TM8192 1.1 dB and TC512 1.0 dB (perftest), stopped as the f32
    anchors; flooding (`--i8-flooding`/`--i16-flooding`, impl cuda_qc, the
    reference clamp-everywhere semantics) at TM8192 1.1 dB, 8192 trials."""
    dtype_name = f"int{bits}"
    scale = {8: 16, 16: 256}[bits]
    if flooding:
        impl, name = "cuda_qc", {8: OUT_I8_FLOOD, 16: OUT_I16_FLOOD}[bits]
        budget = (33_554_432, 10**9)
        kind = "FLOODING-path (reference clamp-everywhere semantics)"
        points = [("TM8192", 1.1, "ebn0")]
    else:
        impl, name = "cuda_layered", {8: OUT_I8, 16: OUT_I16}[bits]
        budget = (16_000_000, 5_000)
        kind = "production-path (layered, wide posterior accumulator)"
        points = [("TM8192", 1.1, "ebn0"), ("TC512", 1.0, "perftest")]
    rows = []
    for code, snr, model in points:
        rows += _points(run, code, [snr], model, *budget, dtype_name=dtype_name, impl=impl)
    header = (
        f"# {dtype_name} {kind} anchor(s) measured on {{card}}\n"
        f"# (labrador_ldpc_tpu_torch.tools.gen_ber_anchors; impl={impl}, dtype={dtype_name},\n"
        f"# llr_scale={scale}, maxiters=100, batch=4096, seed 0).\n"
        + COLUMNS
    )
    write_table(out / name, header, rows, run, "gen_ber_anchors", argv)
    return out / name


def main_sp(run: Run, out, argv):
    """The layered sum-product anchor (impl cuda_sp, the sum-product kernel)
    at TM8192 0.9 dB, 8192 trials."""
    rows = _points(run, "TM8192", [0.9], "ebn0", 33_554_432, 10**9, impl="cuda_sp")
    header = (
        "# Layered sum-product quality-surface anchor measured on {card}\n"
        "# (labrador_ldpc_tpu_torch.tools.gen_ber_anchors --sp; impl=cuda_sp, the\n"
        "# layered BP kernel, true-LLR scaling in the trial step,\n"
        "# maxiters=100, batch=4096, 8192 trials, seed 0).\n"
        + COLUMNS
    )
    write_table(out / OUT_SP, header, rows, run, "gen_ber_anchors", argv)
    return out / OUT_SP


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    which = ap.add_mutually_exclusive_group()
    for flag in ("--sp", "--i8-flooding", "--i8", "--i16-flooding", "--i16"):
        which.add_argument(flag, action="store_true")
    add_run_args(ap)
    args = ap.parse_args(argv)
    out = out_dir(args.out_dir)
    run = make_run(args)
    if args.sp:
        main_sp(run, out, argv)
    elif args.i8_flooding or args.i16_flooding:
        main_int(8 if args.i8_flooding else 16, True, run, out, argv)
    elif args.i8 or args.i16:
        main_int(8 if args.i8 else 16, False, run, out, argv)
    else:
        anchors(run, out, argv)
    print(run.summary(), flush=True)


if __name__ == "__main__":
    main()
