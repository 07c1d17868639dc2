"""Command-line harness: BER/FER waterfall sweeps and the code table.

PyTorch counterpart of `python -m labrador_ldpc_tpu`, with the port's decoder
names and a `--device` flag (default cuda):

    python -m labrador_ldpc_tpu_torch waterfall --decoder bf --noise-model bsc \\
        --code TM8192 --snrs 0.006 --device cpu
    python -m labrador_ldpc_tpu_torch waterfall --code TM8192 --snrs 1.1 \\
        --noise-model ebn0 --dtype int8 --impl cuda_qc
    python -m labrador_ldpc_tpu_torch waterfall --code TM8192 --snrs 0.9 \\
        --noise-model ebn0 --impl sp_layered
    python -m labrador_ldpc_tpu_torch waterfall --code TM8192 --snrs 1.1 \\
        --noise-model ebn0 --dtype bfloat16
    python -m labrador_ldpc_tpu_torch waterfall --code TC512 --snrs 1.5 \\
        --profile traces/
    python -m labrador_ldpc_tpu_torch info
    python -m labrador_ldpc_tpu_torch sizes

`sizes` prints the CUDA decoders' launch shapes and device memory per code
(`sizes.format_memory_table`) and the reference crate's RAM table; it is
plain Python and needs no card. `--profile DIR` writes the sweep's
`torch.profiler` Chrome trace to `DIR/waterfall_<code>.json` (README,
"Spans"). The CSV schema matches the reference perftest
(`code,snr,trials,bits,errors,ber`, perftest/src/main.rs:62).
"""

from __future__ import annotations

import argparse
import contextlib
import sys

SP_IMPLS = ("sp", "sp_layered", "cuda_sp")  # sum-product: float32 true LLRs, decoder ms
MS_IMPLS = ("auto", "ref", "qc", "qc_i8", "qc_i16", "layered", "cuda_layered", "cuda_qc",
            *SP_IMPLS)
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
    if args.impl in SP_IMPLS:
        if args.dtype != "float32":
            raise SystemExit(f"error: --impl {args.impl} (sum-product) is float32-only")
        if args.decoder == "ms_hard":
            raise SystemExit(
                f"error: --decoder ms_hard does not take --impl {args.impl}: sum-product needs "
                "true channel LLRs, and ms_hard feeds fixed +-1 LLRs (use --decoder ms)"
            )
        if args.alpha is not None:
            raise SystemExit(f"error: --impl {args.impl} (sum-product) takes no --alpha")
    if args.dtype == "float64" and args.impl in ("cuda_layered", "cuda_qc"):
        raise SystemExit(f"error: --impl {args.impl} takes float32/bfloat16/int8/int16 LLRs, as "
                         "the TPU kernels do; --dtype float64 takes --impl layered|qc|ref (or "
                         "auto)")
    if args.decoder == "ms_hard" and args.impl in ("qc_i8", "qc_i16"):
        raise SystemExit(f"error: --decoder ms_hard is float32-only; --impl {args.impl} "
                         "decodes int LLRs")
    if args.decoder == "ms":
        if args.impl == "qc_i8" and args.dtype != "int8":
            raise SystemExit("error: --impl qc_i8 requires --dtype int8")
        if args.impl == "qc_i16" and args.dtype != "int16":
            raise SystemExit("error: --impl qc_i16 requires --dtype int16")
        if args.dtype == "int32" and args.impl not in ("ref", "auto"):
            raise SystemExit("error: --dtype int32 requires --impl ref (or auto)")
        if args.llr_scale is not None and args.dtype not in ("int8", "int16"):
            raise SystemExit("error: --llr-scale quantizes --dtype int8/int16 only")
    else:
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
    with _profiled(args.profile, f"waterfall_{args.code}", args.device):
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


@contextlib.contextmanager
def _profiled(out_dir: str | None, name: str, device):
    """With `out_dir`, run the block under `torch.profiler` (host, and the
    card's activity on a CUDA device) and write its Chrome trace to
    `out_dir/<name>.json`: the port's spans (`utils.tracing`) over the
    device's kernels and copies, on one clock. Without, just run it."""
    if out_dir is None:
        yield
        return
    from pathlib import Path

    import torch

    from .device import resolve_device

    acts = [torch.profiler.ProfilerActivity.CPU]
    if resolve_device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    # shapes recorded: the spans' args (a batch's index, a point's snr) go
    # into the trace with them
    with torch.profiler.profile(activities=acts, record_shapes=True) as prof:
        yield
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"{name}.json"
    prof.export_chrome_trace(str(path))
    print(f"trace: {path}", file=sys.stderr, flush=True)


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


def _cmd_sizes(args) -> int:
    from .sizes import format_memory_table, format_reference_table

    print(format_memory_table())
    print()
    print(format_reference_table())
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
                   help="LLR dtype of --decoder ms; int8/int16 are quantized with "
                        "--llr-scale, the others are the float32 LLRs cast (float64 "
                        "takes --impl layered|qc|ref)")
    w.add_argument("--alpha", type=float, default=None, help="normalized min-sum factor")
    w.add_argument("--impl", choices=sorted(set(MS_IMPLS + BF_IMPLS)),
                   default="auto",
                   help="decoder implementation (default auto: the hand-written CUDA "
                        "layered kernel on a CUDA device, ref for int32); --decoder "
                        f"ms/ms_hard take {'|'.join(MS_IMPLS)} (sum-product "
                        f"{'|'.join(SP_IMPLS)}: float32, --decoder ms only), --decoder bf "
                        f"{'|'.join(BF_IMPLS)}")
    w.add_argument("--llr-scale", type=float, default=None,
                   help="int-LLR quantizer scale (default: 16 for int8, 256 for int16)")
    w.add_argument("--seed", type=int, default=0)
    w.add_argument("--checkpoint", default=None, metavar="PATH",
                   help="persist partial counts to PATH (JSONL) and resume "
                        "an interrupted sweep from it")
    w.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    w.add_argument("--verbose", action="store_true")
    w.add_argument("--profile", default=None, metavar="DIR",
                   help="run the sweep under torch.profiler and write its Chrome trace "
                        "(the port's ldpc.* spans over the card's kernels) to DIR")
    w.set_defaults(fn=_cmd_waterfall)

    i = sub.add_parser("info", help="print the code registry table")
    i.set_defaults(fn=_cmd_info)

    z = sub.add_parser("sizes", help="print the per-code launch shape and memory tables")
    z.set_defaults(fn=_cmd_sizes)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
