"""Command-line harness: BER/FER waterfall sweeps and the code table.

PyTorch counterpart of `python -m labrador_ldpc_tpu`, with the port's decoder
names and a `--device` flag (default cuda):

    python -m labrador_ldpc_tpu_torch waterfall --decoder bf --noise-model bsc \\
        --code TM8192 --snrs 0.006 --device cpu
    python -m labrador_ldpc_tpu_torch info

The CSV schema matches the reference perftest (`code,snr,trials,bits,errors,
ber`, perftest/src/main.rs:62).
"""

from __future__ import annotations

import argparse
import sys

MS_IMPLS = ("auto", "layered", "cuda_layered")
BF_IMPLS = ("auto", "cuda", "qc", "gather")


def _cmd_waterfall(args) -> int:
    from .channel.waterfall import waterfall

    # validate the flag combinations up front with a clear CLI error (the
    # library raises too, but argparse errors are friendlier)
    if args.decoder == "bf":
        if args.impl not in BF_IMPLS:
            raise SystemExit(f"error: --decoder bf takes --impl {'|'.join(BF_IMPLS)}")
    elif args.impl not in MS_IMPLS:
        raise SystemExit(f"error: --decoder {args.decoder} takes --impl {'|'.join(MS_IMPLS)}")
    if args.decoder == "ms_hard":
        if args.noise_model == "bec":
            raise SystemExit(
                "error: --noise-model bec requires --decoder bf (erased bits enter hard "
                "decoders as 0; ms_hard takes bsc/perftest/ebn0)"
            )
    elif args.decoder == "ms" and args.noise_model in ("bsc", "bec"):
        raise SystemExit(
            f"error: --noise-model {args.noise_model} requires --decoder "
            f"bf{' or ms_hard' if args.noise_model == 'bsc' else ''}"
        )
    if args.decoder != "ms":
        if args.dtype != "float32":
            raise SystemExit(
                f"error: --decoder {args.decoder} takes hard bits and is float32-only; use "
                "--decoder ms for quantized fronts"
            )
        if args.alpha is not None or args.llr_scale is not None:
            raise SystemExit(
                f"error: --decoder {args.decoder} ignores --alpha/--llr-scale; drop them"
            )

    if args.snrs:
        snrs = [float(s) for s in args.snrs.split(",")]
    else:
        snrs = [round(args.snr_start + args.snr_step * i, 10) for i in
                range(int(round((args.snr_stop - args.snr_start) / args.snr_step)) + 1)]
    waterfall(
        args.code,
        snrs,
        batch=args.batch,
        maxiters=args.maxiters,
        max_bits=args.max_bits,
        max_bit_errors=args.max_bit_errors,
        noise_model=args.noise_model,
        dtype_name=args.dtype,
        alpha=args.alpha,
        impl=args.impl,
        llr_scale=args.llr_scale,
        seed=args.seed,
        csv_out=sys.stdout,
        verbose=args.verbose,
        checkpoint=args.checkpoint,
        decoder=args.decoder,
        device=args.device,
    )
    return 0


def _cmd_info(args) -> int:
    from .codes.params import ALL_CODES

    print(f"{'code':8} {'n':>6} {'k':>6} {'rate':>6} {'p':>5} {'M':>5} {'b':>4} {'|E|':>6}")
    for c in ALL_CODES:
        p = c.params
        print(
            f"{c.value:8} {p.n:>6} {p.k:>6} {p.rate:>6.3f} {p.punctured_bits:>5} "
            f"{p.submatrix_size:>5} {p.circulant_size:>4} {p.paritycheck_sum:>6}"
        )
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="labrador_ldpc_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    w = sub.add_parser("waterfall", help="BER/FER waterfall sweep (perftest analog)")
    w.add_argument("--code", default="TC512", help="code name (default TC512, as perftest)")
    w.add_argument("--snrs", default=None, help="comma-separated SNR (dB) list")
    w.add_argument("--snr-start", type=float, default=0.8)  # perftest/src/main.rs:67-70
    w.add_argument("--snr-stop", type=float, default=2.2)
    w.add_argument("--snr-step", type=float, default=0.1)
    w.add_argument("--batch", type=int, default=1024)
    w.add_argument("--maxiters", type=int, default=100)  # perftest uses 100
    w.add_argument("--max-bits", type=int, default=50_000_000)
    w.add_argument("--max-bit-errors", type=int, default=5_000)
    w.add_argument("--noise-model",
                   choices=["perftest", "ebn0", "bsc", "bec"],
                   default="perftest",
                   help="soft-noise convention, or a hard channel "
                        "('bsc' flips / 'bec' erases-to-0: --snrs values are "
                        "probabilities, not dB)")
    w.add_argument("--decoder", choices=["ms", "ms_hard", "bf"],
                   default="ms",
                   help="decode surface: min-sum (soft), min-sum on "
                        "hard-sliced input, or bit-flip (channel/hard.py)")
    w.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16", "float64", "int8", "int16", "int32"],
                   help="LLR dtype of --decoder ms (this port decodes float32; the "
                        "others name the roadmap item that brings them)")
    w.add_argument("--alpha", type=float, default=None, help="normalized min-sum factor")
    w.add_argument("--impl", choices=sorted(set(MS_IMPLS + BF_IMPLS)),
                   default="auto",
                   help="decoder implementation (default auto: the hand-written CUDA "
                        f"kernel on a CUDA device); --decoder ms/ms_hard take "
                        f"{'|'.join(MS_IMPLS)}, --decoder bf {'|'.join(BF_IMPLS)}")
    w.add_argument("--llr-scale", type=float, default=None,
                   help="int-LLR quantizer scale (int dtypes, ROADMAP Queue A5)")
    w.add_argument("--seed", type=int, default=0)
    w.add_argument("--checkpoint", default=None, metavar="PATH",
                   help="persist partial counts to PATH (JSONL) and resume "
                        "an interrupted sweep from it")
    w.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    w.add_argument("--verbose", action="store_true")
    w.set_defaults(fn=_cmd_waterfall)

    i = sub.add_parser("info", help="print the code registry table")
    i.set_defaults(fn=_cmd_info)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
