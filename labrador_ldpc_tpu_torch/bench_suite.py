"""Microbenchmark suite of the port on one card: nine codes, every kernel form.

Counterpart of `benchmarks/bench_suite.py` (the JAX package on a TPU), row
family by row family, with `pallas` renamed `cuda` in labels and impls
(reference harnesses: benches/encode.rs:25-59, benches/decode.rs:22-101,
benches/iter_paritychecks.rs:14-22):

  encode, encode_data_rate         batched encoder, cw/s and data MB/s
  decode_bf[cuda]                  the bit-flip kernel, 3 flips, maxiters 50
  bf_iter[cuda]                    the bit-flip kernel on random bits, 20 iterations
  decode_sp[cuda]                  the layered sum-product kernel, 3 flips as +-4
                                   LLRs, maxiters 50, on the M >= 512 codes
  decode_ms[impl,dtype]            min-sum, 3 flips, maxiters 50
  ms_iter[impl,dtype]              min-sum on noise, 20 iterations (float32, bfloat16)
  table_build_edges_per_s          `codes.expand.decoder_tables` build, host
  capi_encode, capi_decode_ms_f32  the native scalar codec (`capi`), one codeword, host
  --two-stage: decode_threshold[layered100|two_stage|two_stage_lay], TM8192
                                   at Eb/N0 1.1 and 1.5 dB, with the failures

The batch is `--batch` x 8 for codes of n <= 2048 and x 4 above (16384 at
the default 4096, the headline `bench` batch).

Where the port differs from the JAX suite:

- The default impl list is the kernel forms: `cuda_layered` and `cuda_qc`,
  each in float32, bfloat16, int8 and int16. The plain decoders (`ref`,
  `qc`, `layered`, `qc_i8`, `qc_i16`) are the tests' references and run on
  no card path of the port, so they run only when `--impls` names them (in
  the JAX package the XLA twins are production paths, and its default list
  has them). The same holds for the plain bit-flip rows (`decode_bf`,
  `bf_iter`): `--impls` runs them when it names `bf_qc`.
- Every kernel row is first held against its plain version on the card, on
  the first 256 frames of the row's batch: bits, success and iterations
  must be equal. A kernel row that raises, differs or fails its convergence
  check is printed as a SKIP and never falls back to the plain version;
  `--strict` then exits 1.
- Every device row is timed by `utils.timing.pipelined_fit`: trains of up to
  `--pipeline` dispatches, best of `--reps`, the least-squares slope,
  synchronised by a copy of the smallest tensor of the last result to the
  host. This replaces the JAX suite's amortized `_timeit`, the fault that
  `tools/slope_rates.py` exists to correct, so the port has no separate
  slope tool. The host rows (`capi_*`, `table_build_edges_per_s`) keep
  `time.perf_counter`.
- `--parity-first` (the TPU tool `tools/tpu_parity.py`) is not ported: its
  counterpart is `chip_smoke.py`'s phases 4, 8 and 10-12 and the check on
  every kernel row.
- Rows are appended as JSON lines to `--out` (default
  `chiprun_out/bench_suite_torch.jsonl`), never to
  `benchmarks/results.jsonl`; every row carries `device` (the card's name)
  and `power_limit_w`. The `capi_*` rows say `cpu-scalar` and the host
  CPU's model.
- It runs on the card only: without one it raises. `--device cpu` exists for
  the tests, and its rows say `cpu`.

    python -m labrador_ldpc_tpu_torch.bench_suite --quick
    python -m labrador_ldpc_tpu_torch.bench_suite --strict
    python -m labrador_ldpc_tpu_torch.bench_suite --two-stage
"""

from __future__ import annotations

import argparse
import json
import platform
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from . import capi
from .channel.awgn import _make_decoder, make_two_stage_decoder, noise_sigma
from .codes.expand import decoder_tables, qc_structure
from .codes.params import ALL_CODES, get_code
from .device import describe_card, resolve_device
from .ops.bitflip import bitflip_plain, make_bf_decoder_qc
from .ops.convert import hard_to_llrs, unpack_bits
from .ops.cuda_bf import make_bf_decoder_cuda
from .ops.cuda_layered import make_ms_decoder_cuda_layered
from .ops.cuda_sp import make_sp_decoder_cuda
from .ops.encoder import encode_bits, make_encoder
from .ops.qc_minsum import flooding_minsum_plain, layered_minsum_plain
from .ops.sumproduct import layered_sp_plain
from .serve import FLIPS
from .utils.timing import Fit, pipelined_fit

__all__ = ["KERNEL_IMPLS", "Suite", "bench_all", "bench_capi", "bench_two_stage", "main"]

OUT = Path(__file__).resolve().parents[1] / "chiprun_out" / "bench_suite_torch.jsonl"
KERNEL_IMPLS = tuple((impl, dtype) for impl in ("cuda_layered", "cuda_qc")
                     for dtype in ("float32", "bfloat16", "int8", "int16"))
PLAIN_BF = "bf_qc"  # an --impls entry that runs the plain bit-flip rows
# each kernel impl's plain version: fn(QCStructure, llrs, maxiters) -> MSResult
PLAIN_MS = {"cuda_layered": layered_minsum_plain, "cuda_qc": flooding_minsum_plain}
MAXITERS = 50
ITERS = 20  # the fixed budget of the bf_iter and ms_iter rows
CHECK_FRAMES = 256  # frames of a kernel row held against its plain version
HOST_CALLS = 8  # calls a repetition of a host row
MIN_SP_M = 512  # decode_sp runs on the codes the JAX package serves from its SP kernel


def _sync(out) -> None:
    """Wait for all enqueued work: copy the smallest tensor of the last
    result to the host (launches on one stream run in order, so the copy
    cannot finish early); a large one is cut to 8 elements first."""
    tensors = [t for t in (out if isinstance(out, tuple) else (out,))
               if isinstance(t, torch.Tensor)]
    a = min(tensors, key=lambda t: t.numel())
    if a.numel() > (1 << 16):
        a = a.reshape(-1)[:8]
    a.cpu()


def _equal(got, want) -> bool:
    """Bits, success and iterations identical (as integers)."""
    return all(torch.equal(getattr(got, f).long(), getattr(want, f).long())
               for f in ("bits", "success", "iterations"))


def _all_converged(res) -> str | None:
    return None if bool(res.success.all()) else "failed the 3-bit-flip convergence check"


def _runs_fixed_budget(res) -> str | None:
    conv = float(res.success.float().mean())
    return f"the random input converged {conv:.0%}" if conv > 0.05 else None


def _cpu_model() -> str:
    try:
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            if line.startswith("model name"):
                return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or platform.machine()


class Suite:
    """One run's settings, its output file and the kernel rows that failed."""

    def __init__(self, device, out, run_filter: str = "", pipeline: int = 32, reps: int = 3):
        self.dev = resolve_device(device)
        self.card = describe_card(self.dev)
        self.out = out  # an open text file, or None
        self.run_filter = run_filter
        self.pipeline = pipeline
        self.reps = reps
        self.stamp = round(time.time(), 1)
        self.rows: list[dict] = []
        self.violations: list[str] = []

    def want(self, label: str) -> bool:
        """--filter matches the family (the label up to '[') or the label."""
        f = self.run_filter
        return not f or f in label.split("[", 1)[0] or f in label

    def skip(self, label: str, code: str, reason: str, kernel: bool) -> None:
        """Print a row that was not recorded; a kernel row's is a violation."""
        msg = f"{label} {code}: SKIP ({reason})"
        print(msg, flush=True)
        if kernel:
            self.violations.append(msg)

    def record(self, bench: str, code: str, value: float, unit: str, **meta) -> None:
        row = {"bench": bench, "code": code, "value": round(value, 3), "unit": unit,
               "device": self.card["name"], "power_limit_w": self.card["power_limit_w"], **meta}
        self.rows.append(row)
        if self.out is not None:
            self.out.write(json.dumps({"ts": self.stamp, **row}) + "\n")
            self.out.flush()
        print(f"{bench:36} {code:8} {value:>16,.1f} {unit}", flush=True)

    def fit(self, fn) -> Fit:
        return pipelined_fit(lambda _: fn(), None, _sync, k=self.pipeline, reps=self.reps)

    def device_row(self, label: str, code: str, make, x: torch.Tensor, work: float, unit: str,
                   plain=None, accept=None, note=None, **meta) -> Fit | None:
        """Build `make()`'s decoder, run it on `x`, hold it against `plain` on
        the first CHECK_FRAMES frames (a kernel row: every row whose decoder
        launches a kernel has a plain version), apply `accept(result)`
        (a reason to skip, or None), then record `work` a dispatch over the
        fitted seconds a dispatch; `note(result)` adds fields to the row. An
        exception is printed and the row skipped."""
        if not self.want(label):
            return None
        try:
            dec = make()
            res = dec(x)
            _sync(res)
            if plain is not None:
                n = min(CHECK_FRAMES, x.shape[0])
                if not _equal(dec(x[:n]), plain(x[:n])):
                    self.skip(label, code, f"differs from its plain version on the card on the "
                                           f"first {n} frames", kernel=True)
                    return None
            reason = accept(res) if accept is not None else None
            if reason is not None:
                self.skip(label, code, reason, kernel=plain is not None)
                return None
            fit = self.fit(lambda: dec(x))
        except Exception as e:  # noqa: BLE001 - a failed row is reported, the sweep goes on
            traceback.print_exc()
            self.skip(label, code, f"{type(e).__name__}: {e}", kernel=plain is not None)
            return None
        extra = note(res) if note is not None else {}
        self.record(label, code, fit.rate(work), unit, batch=int(x.shape[0]),
                    r2=round(fit.r2, 6), **meta, **extra)
        return fit


def bench_all(suite: Suite, codes, impls, base_batch: int, plain_bf: bool = False) -> None:
    """The per-code rows (see the module docstring)."""
    dev = suite.dev
    rng = np.random.default_rng(0)
    for name in codes:
        code = get_code(name)
        s = qc_structure(code)
        batch = base_batch * 8 if code.n <= 2048 else base_batch * 4
        k_bytes = code.k // 8
        g = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 31)))
        data = torch.from_numpy(rng.integers(0, 256, (batch, k_bytes), dtype=np.uint8)).to(dev)

        # --- encode (benches/encode.rs: b.bytes = k/8) ---------------------------
        enc = make_encoder(code, device=dev)
        fit = suite.device_row("encode", name, lambda: enc, data, batch, "cw/s")
        if fit is not None and suite.want("encode_data_rate"):
            suite.record("encode_data_rate", name, fit.rate(batch * k_bytes) / 1e6, "MB/s",
                         batch=batch, r2=round(fit.r2, 6))

        # --- 3-flip fixtures (decode.rs:52) ------------------------------------------
        cw = enc(data)
        cw[:, 0] ^= FLIPS
        bits = unpack_bits(cw, dev)

        # --- decode_bf (benches/decode.rs:22-37): the kernel, and on request
        # the plain version ------------------------------------------------------------
        suite.device_row("decode_bf[cuda]", name, lambda: make_bf_decoder_cuda(code, MAXITERS, dev),
                         bits, batch, "cw/s", plain=lambda h: bitflip_plain(s, h, MAXITERS),
                         maxiters=MAXITERS)
        if plain_bf:
            suite.device_row("decode_bf", name, lambda: make_bf_decoder_qc(code, MAXITERS, dev),
                             bits, batch, "cw/s", maxiters=MAXITERS)

        # --- bf_iter: random bits (almost) never satisfy every check, so the
        # batch runs the fixed budget: the fixture-independent bit-flip rate
        rand_bits = torch.randint(0, 2, (batch, code.n), generator=g, device=dev,
                                  dtype=torch.uint8)
        suite.device_row("bf_iter[cuda]", name, lambda: make_bf_decoder_cuda(code, ITERS, dev),
                         rand_bits, batch * ITERS, "cw_iter/s",
                         plain=lambda h: bitflip_plain(s, h, ITERS), accept=_runs_fixed_budget,
                         maxiters=ITERS)
        if plain_bf:
            suite.device_row("bf_iter", name, lambda: make_bf_decoder_qc(code, ITERS, dev),
                             rand_bits, batch * ITERS, "cw_iter/s", accept=_runs_fixed_budget,
                             maxiters=ITERS)

        # --- decode_sp: the layered sum-product kernel on the codes the JAX
        # package serves from its SP kernel (M >= 512), with the 3 flips as
        # +-4 LLRs (belief propagation is scale-sensitive; 4 is about a
        # BSC(2%) LLR) ------------------------------------------------------------------
        if code.submatrix_size >= MIN_SP_M and suite.want("decode_sp[cuda]"):
            sp_llrs = hard_to_llrs(cw, torch.float32, dev) * 4.0
            suite.device_row("decode_sp[cuda]", name,
                             lambda: make_sp_decoder_cuda(code, MAXITERS, dev), sp_llrs, batch,
                             "cw/s", plain=lambda x: layered_sp_plain(s, x, MAXITERS),
                             accept=_all_converged, maxiters=MAXITERS)

        # --- decode_ms (benches/decode.rs:39-71) -------------------------------------
        for impl, dtype_name in impls:
            label = f"decode_ms[{impl},{dtype_name}]"
            if not suite.want(label):
                continue
            dtype = getattr(torch, dtype_name)
            plain = PLAIN_MS.get(impl)
            suite.device_row(
                label, name, lambda: _make_decoder(code, dtype, MAXITERS, None, impl, dev),
                hard_to_llrs(cw, dtype, dev), batch, "cw/s",
                plain=None if plain is None else (lambda x: plain(s, x, MAXITERS)),
                accept=_all_converged, maxiters=MAXITERS, impl=impl, dtype=dtype_name)

        # --- ms_iter: pure-noise LLRs (almost) never converge, so the batch runs
        # the fixed budget: the kernel's rate apart from the early exit
        noise = torch.randn((batch, code.n), generator=g, device=dev)
        for impl, dtype_name in impls:
            label = f"ms_iter[{impl},{dtype_name}]"
            if dtype_name not in ("float32", "bfloat16") or not suite.want(label):
                continue
            dtype = getattr(torch, dtype_name)
            plain = PLAIN_MS.get(impl)
            suite.device_row(
                label, name, lambda: _make_decoder(code, dtype, ITERS, None, impl, dev),
                noise.to(dtype), batch * ITERS, "cw_iter/s",
                plain=None if plain is None else (lambda x: plain(s, x, ITERS)),
                accept=_runs_fixed_budget, maxiters=ITERS, impl=impl, dtype=dtype_name)
        del noise, rand_bits

        # --- table build (the iter_paritychecks.rs analog), host --------------------
        if suite.want("table_build_edges_per_s"):
            decoder_tables.cache_clear()
            t0 = time.perf_counter()
            tabs = decoder_tables(code)
            t = time.perf_counter() - t0
            suite.record("table_build_edges_per_s", name, tabs.n_edges / t, "edges/s")


def bench_two_stage(suite: Suite, batch: int = 16384) -> None:
    """Two-stage decoders against the plain layered kernel at maxiters 100,
    TM8192 at Eb/N0 1.1 dB (the BER anchor, a broad iteration distribution)
    and 1.5 dB (past the waterfall, sparse stragglers): the pairings of the
    JAX suite under the port's names. Each row records its failures on the
    whole batch; the two-stage rows synchronise inside (the success mask), so
    their slope is a call's whole time."""
    dev = suite.dev
    code = get_code("TM8192")
    s = qc_structure(code)
    rng = np.random.default_rng(7)
    data = torch.from_numpy(rng.integers(0, 2, (batch, code.k), dtype=np.uint8)).to(dev)
    tx = 1.0 - 2.0 * encode_bits(code, data, dev).float()
    g = torch.Generator(device=dev).manual_seed(7)
    f32 = torch.float32

    def failures(res):
        return {"failures": int((~res.success).sum())}

    for snr in (1.1, 1.5):
        noisy = tx + noise_sigma(snr, code, "ebn0") * torch.randn(tx.shape, generator=g,
                                                                   device=dev)
        rows = (
            ("decode_threshold[layered100]",
             lambda: make_ms_decoder_cuda_layered(code, 100, device=dev),
             lambda x: layered_minsum_plain(s, x, 100)),
            ("decode_threshold[two_stage]",
             lambda: make_two_stage_decoder(code, 25, 100, f32, f32, "cuda_layered", "cuda_qc",
                                            dev),
             make_two_stage_decoder(code, 25, 100, f32, f32, "layered", "qc", dev)),
            # a layered rescue: the rescue reruns the same deterministic layered
            # decode from the same LLRs with the same budget, so its quality is
            # layered100's; the fast pass stops easy frames at 25 iterations
            ("decode_threshold[two_stage_lay]",
             lambda: make_two_stage_decoder(code, 25, 100, f32, f32, "cuda_layered",
                                            "cuda_layered", dev),
             make_two_stage_decoder(code, 25, 100, f32, f32, "layered", "layered", dev)),
        )
        for label, make, plain in rows:
            suite.device_row(label, code.value, make, noisy, batch, "cw/s",
                             plain=plain, note=failures, snr_db=snr)


def _host_seconds(fn, reps: int) -> float:
    """Best of `reps` of the mean of HOST_CALLS calls, host clock."""
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            fn()
        best = min(best, (time.perf_counter() - t0) / HOST_CALLS)
    return best


def bench_capi(suite: Suite, codes, reps: int) -> None:
    """The native scalar codec, one codeword a call, on the host CPU."""
    host = {"device": f"cpu-scalar ({_cpu_model()})", "power_limit_w": None}
    rng = np.random.default_rng(0)
    for name in codes:
        code = get_code(name)
        data = rng.integers(0, 256, code.k // 8, dtype=np.uint8)
        try:
            cw = capi.copy_encode(code, data)
            if suite.want("capi_encode"):
                t = _host_seconds(lambda: capi.copy_encode(code, data), reps * 20)
                suite.record("capi_encode", name, 1 / t, "cw/s", **host)
            if suite.want("capi_decode_ms_f32"):
                rx = cw.copy()
                rx[0] ^= FLIPS
                llrs = capi.hard_to_llrs(code, rx, np.float32)
                ok, _, out = capi.decode_ms(code, llrs, maxiters=MAXITERS)
                if not ok or not np.array_equal(out[: code.n // 8], cw):
                    suite.skip("capi_decode_ms_f32", name, "failed the 3-bit-flip check",
                               kernel=False)
                    continue
                t = _host_seconds(lambda: capi.decode_ms(code, llrs, maxiters=MAXITERS), reps)
                suite.record("capi_decode_ms_f32", name, 1 / t, "cw/s", maxiters=MAXITERS, **host)
        except (OSError, RuntimeError) as e:  # no g++, or the build failed
            suite.skip("capi", name, f"{type(e).__name__}: {e}", kernel=False)


def _parse_impls(spec: str | None) -> tuple[list[tuple[str, str]], bool]:
    if spec is None:
        return list(KERNEL_IMPLS), False
    impls, plain_bf = [], False
    for item in spec.split(","):
        if item == PLAIN_BF:
            plain_bf = True
        elif ":" in item:
            impls.append(tuple(item.split(":", 1)))
        else:
            raise SystemExit(f"--impls takes impl:dtype pairs or {PLAIN_BF!r}, got {item!r}")
    return impls, plain_bf


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--quick", action="store_true", help="TC128 + TM8192 only")
    ap.add_argument("--codes", default=None, help="comma-separated code list")
    ap.add_argument("--batch", type=int, default=4096,
                    help="base batch: x8 for codes of n <= 2048, x4 above")
    ap.add_argument("--reps", type=int, default=3, help="best of this many trains a point")
    ap.add_argument("--pipeline", type=int, default=32, help="dispatches in the longest train")
    ap.add_argument("--filter", default="",
                    help="only run (and record) rows whose family (the label up to '[') or "
                         "label contains this substring, e.g. 'bf' or 'ms_iter'")
    ap.add_argument("--impls", default=None,
                    help="comma-separated impl:dtype pairs (e.g. 'cuda_qc:int8'), and "
                         f"'{PLAIN_BF}' for the plain bit-flip rows; default: the kernel forms")
    ap.add_argument("--no-capi", action="store_true")
    ap.add_argument("--two-stage", action="store_true",
                    help="only the TM8192 two-stage comparison at 1.1 and 1.5 dB")
    ap.add_argument("--strict", action="store_true",
                    help="exit 1 if a kernel row skips, raises or differs from its plain version")
    ap.add_argument("--out", type=Path, default=OUT, help="JSON lines are appended here")
    ap.add_argument("--device", default="cuda", help="'cpu' exists for the tests only")
    args = ap.parse_args(argv)
    impls, plain_bf = _parse_impls(args.impls)
    if args.codes:
        codes = args.codes.split(",")
    elif args.quick:
        codes = ["TC128", "TM8192"]
    else:
        codes = [c.value for c in ALL_CODES]
    for name in codes:
        get_code(name)  # an unknown name fails before any work

    # the device first: without a card this raises before a file is touched
    suite = Suite(args.device, None, args.filter, args.pipeline, args.reps)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "a") as out:
        suite.out = out
        print(f"device {suite.card['smi'] or suite.card['name']}; torch {torch.__version__}",
              flush=True)
        if args.two_stage:
            bench_two_stage(suite, args.batch * 4)
        else:
            bench_all(suite, codes, impls, args.batch, plain_bf)
            if not args.no_capi and (suite.want("capi_encode")
                                     or suite.want("capi_decode_ms_f32")):
                bench_capi(suite, codes, args.reps)
    print(f"\n{len(suite.rows)} rows appended to {args.out}")
    if args.filter and not suite.rows:
        print(f"WARNING: --filter {args.filter!r} selected no row (check the family/label "
              "spelling)")
    if suite.violations:
        print(f"\n{len(suite.violations)} kernel row(s) skipped or failed:")
        for v in suite.violations:
            print(f"  {v}")
        if args.strict:
            return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
