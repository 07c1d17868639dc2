"""The port's measurement entry points on the CPU: the pipelined fit
(utils/timing.py), the headline benchmark (bench.py), the microbenchmark
suite (bench_suite.py), the native scalar codec's bindings (capi.py) and the
profile aggregation (profile_decode.py).

The fit is held to the JAX package's `pipelined_slope` on the same trains
(exact), the codec to the JAX package's encoder and to its NumPy oracle
(`labrador_ldpc_tpu.utils.oracle`, bit for bit, as `tests/test_capi.py`
holds the JAX bindings; the JAX `capi` itself is not called, since its build
writes `native/liblabrador_ldpc.so`, which that file may be building in
another worker). The benchmark and the suite run their plain versions here
(`device="cpu"`), on a fake clock where a number is checked; their CLIs
refuse to run without a card. Tolerance: exact throughout.
"""

import json
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import labrador_ldpc_tpu.utils.timing as jtiming
from labrador_ldpc_tpu.codes.params import get_code as jget_code
from labrador_ldpc_tpu.ops.encoder import encode as jencode
from labrador_ldpc_tpu.utils import oracle

from golden_vectors import GOLDEN_PARITY

import labrador_ldpc_tpu_torch as T
from labrador_ldpc_tpu_torch import bench, bench_suite, capi, profile_decode
from labrador_ldpc_tpu_torch.device import describe_card
from labrador_ldpc_tpu_torch.ops.minsum import MSResult
from labrador_ldpc_tpu_torch.utils.timing import Fit, pipelined_fit, pipelined_slope

CODES = [c.value for c in T.ALL_CODES]
FLIPS = (1 << 7) | (1 << 5) | (1 << 3)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run PyTorch's CPU ops on one thread (tests/test_torch_layered.py)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def linear_clock(per_dispatch: float, per_sync: float):
    """A fake wall clock on which `fn` costs `per_dispatch` and `sync`
    `per_sync` seconds: (clock, fn, sync)."""
    now = [0.0]

    def fn(x):
        now[0] += per_dispatch
        return x

    def sync(out):
        now[0] += per_sync

    return (lambda: now[0]), fn, sync


def train_clock(durations):
    """A fake wall clock on which the i-th timed train (reps=1) takes
    durations[i] seconds: it reads 0 at each train's start."""
    reads = iter([v for d in durations for v in (0.0, d)])
    return lambda: next(reads)


# ---- utils/timing.py ----------------------------------------------------------------


def test_pipelined_fit_on_a_linear_clock():
    """Trains of c dispatches taking c/128 + 1/32 s (exact in binary): the
    slope, the intercept and R^2 = 1 come out exactly."""
    clock, fn, sync = linear_clock(2.0 ** -7, 2.0 ** -5)
    fit = pipelined_fit(fn, None, sync, k=32, reps=2, clock=clock)
    assert [k for k, _ in fit.points] == [8, 16, 24, 32]
    assert fit.slope == 2.0 ** -7
    assert fit.intercept == 2.0 ** -5
    assert fit.r2 == 1.0
    assert fit.residuals == (0.0, 0.0, 0.0, 0.0)
    assert fit.amortized == 32 / (32 * 2.0 ** -7 + 2.0 ** -5)
    assert fit.rate(16384) == 16384 / 2.0 ** -7


def test_pipelined_slope_is_the_jax_slope(monkeypatch):
    """On the same noisy trains the port's fit (and `pipelined_slope`, its
    slope) equals the JAX package's `pipelined_slope`, which reads
    time.perf_counter (replaced here by the fake clock)."""

    def noisy():
        rng = np.random.default_rng(3)
        now = [0.0]

        def fn(x):
            now[0] += 0.004 + float(rng.uniform(0, 0.001))
            return x

        def sync(out):
            now[0] += 0.03 + float(rng.uniform(0, 0.01))

        return (lambda: now[0]), fn, sync

    clock, fn, sync = noisy()
    monkeypatch.setattr(jtiming, "time", types.SimpleNamespace(perf_counter=clock))
    want = jtiming.pipelined_slope(fn, None, sync, k=32, reps=3)
    clock, fn, sync = noisy()
    fit = pipelined_fit(fn, None, sync, k=32, reps=3, clock=clock)
    clock, fn, sync = noisy()
    assert fit.slope == want == pipelined_slope(fn, None, sync, k=32, reps=3, clock=clock)
    assert 0.0 < fit.r2 < 1.0


# ---- bench.py -----------------------------------------------------------------------


def test_bench_line_and_cap_on_the_cpu():
    """bench at B=64 on the CPU with a fake clock: the JSON line's keys and
    metric name; trains that take the same time give a near-zero slope, so
    the rate is capped at 1.5x the longest train's amortized rate."""
    durations = [1.0, 1.0, 1.0, 1.0 + 2.0 ** -20]
    r = bench.measure(batch=64, pipeline=4, reps=1, device="cpu", clock=train_clock(durations))
    assert set(r.line) == {"metric", "value", "unit", "vs_baseline", "device"}
    assert r.line["metric"] == "TM8192_minsum_f32_decode_throughput_cuda" == bench.METRIC
    assert r.line["unit"] == "codewords/s/chip"
    assert r.line["device"] == "cpu"
    assert r.line["vs_baseline"] is None  # no ratio to the card's baseline from a CPU run
    assert [k for k, _ in r.fit.points] == [1, 2, 3, 4]
    assert r.line["value"] == round(1.5 * 64 * 4 / durations[-1], 1)
    assert r.line["value"] < 64 / r.fit.slope
    d = r.diagnostics()
    assert {"fit_points", "residuals_s", "r_squared", "sec_per_dispatch", "amortized_rate_cw_s",
            "card", "power_limit_w"} <= set(d)
    json.dumps(r.line), json.dumps(d)


def test_bench_rate_from_the_slope():
    """Away from the cap the rate is the batch over the slope."""
    fit = Fit(((8, 0.11), (16, 0.19), (24, 0.27), (32, 0.35)), 0.01, 0.03, 1.0, 32 / 0.35)
    assert fit.rate(64) == pytest.approx(6400.0)
    assert fit.rate(64) < 1.5 * 64 * fit.amortized


def test_entry_points_refuse_to_run_without_a_card(tmp_path):
    """No CPU mode behind the CLIs: each raises where no card is present,
    the suite before it opens its output file."""
    assert not torch.cuda.is_available()
    assert describe_card("cpu") == {"name": "cpu", "power_limit_w": None, "smi": None}
    out = tmp_path / "rows.jsonl"
    for call in (lambda: bench.main([]),
                 lambda: bench_suite.main(["--codes", "TC128", "--out", str(out)]),
                 lambda: profile_decode.main(["--code", "TC128"]),
                 lambda: bench.measure(batch=8)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert not out.exists()


# ---- bench_suite.py -----------------------------------------------------------------

SUITE_CPU = ["--device", "cpu", "--batch", "2", "--pipeline", "4", "--reps", "1"]


def suite_rows(tmp_path, *argv):
    out = tmp_path / "rows.jsonl"
    rc = bench_suite.main([*SUITE_CPU, *argv, "--out", str(out)])
    return rc, [json.loads(line) for line in out.read_text().splitlines()] if out.exists() else []


def test_suite_rows_carry_the_jax_families(tmp_path):
    """TC128 on the CPU with a few impls: each row's label, with `cuda` read
    as `pallas`, is a label the JAX suite records for the same impls."""
    rc, rows = suite_rows(tmp_path, "--codes", "TC128", "--strict", "--impls",
                          "cuda_layered:float32,cuda_qc:int8,layered:bfloat16,bf_qc")
    assert rc == 0
    jax_labels = {
        "encode", "encode_data_rate", "decode_bf", "decode_bf[pallas]", "bf_iter",
        "bf_iter[pallas]", "decode_ms[pallas_layered,float32]", "decode_ms[pallas_qc,int8]",
        "decode_ms[layered,bfloat16]", "ms_iter[pallas_layered,float32]",
        "ms_iter[layered,bfloat16]", "table_build_edges_per_s", "capi_encode",
        "capi_decode_ms_f32",
    }
    assert {r["bench"].replace("cuda", "pallas") for r in rows} == jax_labels
    for r in rows:
        assert r["code"] == "TC128" and r["value"] > 0 and "power_limit_w" in r
        assert r["device"] == ("cpu" if not r["bench"].startswith("capi") else r["device"])
        assert r["device"].startswith("cpu-scalar (") == r["bench"].startswith("capi")
    assert {r["batch"] for r in rows if "batch" in r} == {16}  # 2 x 8 for n <= 2048


def test_suite_filter_default_impls_and_sp_codes(tmp_path):
    """--filter runs one family; decode_sp runs on the M >= 512 codes only;
    the default impl list is the kernel forms, plain decoders only on request."""
    rc, rows = suite_rows(tmp_path, "--codes", "TC128,TM2048", "--filter", "decode_sp",
                          "--strict")
    assert rc == 0
    assert [(r["bench"], r["code"]) for r in rows] == [("decode_sp[cuda]", "TM2048")]
    impls, plain_bf = bench_suite._parse_impls(None)
    assert impls == [(i, d) for i in ("cuda_layered", "cuda_qc")
                     for d in ("float32", "bfloat16", "int8", "int16")]
    assert not plain_bf


def test_strict_exits_1_when_a_kernel_row_differs(tmp_path, monkeypatch, capsys):
    """A kernel whose bits are wrong fails its check against the plain
    version: the row is not recorded (no fallback) and --strict exits 1."""
    real = bench_suite._make_decoder

    def wrong(*args, **kwargs):
        dec = real(*args, **kwargs)

        def decode(x):
            res = dec(x)
            return MSResult(res.success, res.iterations, res.bits ^ 1)

        return decode

    monkeypatch.setattr(bench_suite, "_make_decoder", wrong)
    argv = ("--codes", "TC128", "--impls", "cuda_layered:float32", "--filter", "decode_ms",
            "--no-capi")
    rc, rows = suite_rows(tmp_path, *argv, "--strict")
    assert rc == 1 and rows == []
    assert "decode_ms[cuda_layered,float32] TC128: SKIP (differs from its plain version" in \
        capsys.readouterr().out
    assert suite_rows(tmp_path, *argv) == (0, [])  # reported, but not fatal without --strict


# ---- capi.py ------------------------------------------------------------------------


def test_capi_size_getters_match_params():
    l = capi.lib()
    for i, c in enumerate(T.ALL_CODES):
        p = c.params
        assert l.labrador_ldpc_code_n(i) == p.n
        assert l.labrador_ldpc_code_k(i) == p.k
        assert l.labrador_ldpc_punctured_bits(i) == p.punctured_bits
        assert l.labrador_ldpc_paritycheck_sum(i) == p.paritycheck_sum
        assert l.labrador_ldpc_bf_working_len(i) == p.decode_bf_working_len
        assert l.labrador_ldpc_ms_working_len(i) == p.decode_ms_working_len
        assert l.labrador_ldpc_ms_working_u8_len(i) == p.decode_ms_working_u8_len
        assert l.labrador_ldpc_output_len(i) == p.output_len
    with pytest.raises(ValueError, match="must hold 8 elements"):
        capi.copy_encode("TC128", np.zeros(7, np.uint8))
    with pytest.raises(ValueError, match="int8, int16, float32 or float64"):
        capi.decode_ms("TC128", np.zeros(128, np.int32))


@pytest.mark.parametrize("name", CODES)
def test_capi_equals_the_jax_package(name):
    """copy_encode (and the in-place encode) equal the JAX encoder and the
    golden parity; on a 3-flip codeword decode_ms in f32, i8, i16 and f64 and
    decode_bf equal the JAX package's oracle in success, iterations and
    output bytes."""
    code = T.get_code(name)
    rng = np.random.default_rng(5)
    data = np.concatenate([np.arange(code.k // 8, dtype=np.uint8)[None],
                           rng.integers(0, 256, (2, code.k // 8), dtype=np.uint8)])
    want = np.asarray(jencode(jget_code(name), jnp.asarray(data)))
    got = np.stack([capi.copy_encode(code, d) for d in data])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0, code.k // 8:],
                                  np.frombuffer(GOLDEN_PARITY[name], dtype=np.uint8))
    buf = np.zeros(code.n // 8, np.uint8)
    buf[: code.k // 8] = data[1]
    np.testing.assert_array_equal(capi.encode(code, buf), got[1])
    rx = got[1].copy()
    rx[0] ^= FLIPS
    for dtype in (np.float32, np.int8, np.int16, np.float64):
        llrs = capi.hard_to_llrs(code, rx, dtype)
        np.testing.assert_array_equal(llrs, oracle.hard_to_llrs(name, rx, dtype))
        np.testing.assert_array_equal(capi.llrs_to_hard(code, llrs), rx)
        ok, iters, out = capi.decode_ms(code, llrs, maxiters=50)
        ok_o, it_o, out_o = oracle.decode_ms(name, llrs, maxiters=50)
        assert (ok, iters) == (ok_o, it_o)
        np.testing.assert_array_equal(out, out_o)
        assert ok and np.array_equal(out[: code.n // 8], got[1])
    ok, iters, out = capi.decode_bf(code, rx, maxiters=50)
    ok_o, it_o, out_o = oracle.decode_bf(name, rx, maxiters=50)
    assert (ok, iters) == (ok_o, it_o)
    np.testing.assert_array_equal(out, out_o)


# ---- profile_decode.py ---------------------------------------------------------------


def test_profile_aggregate_on_synthetic_events():
    """Totals and counts by name, most time first; the busy share is the
    union of overlapping intervals over the window; gaps include the
    window's ends and events are clipped to it."""
    events = [("k1", 10, 20), ("k2", 15, 30), ("k1", 40, 45), ("k3", 45, 47),
              ("memcpy", 60, 61), ("k2", 95, 120)]
    p = profile_decode.aggregate(events, window=(0, 100), top=3)
    assert p.top == [("k2", 40.0, 2), ("k1", 15.0, 2), ("k3", 2.0, 1)]
    assert p.busy == pytest.approx((20 + 7 + 1 + 5) / 100)
    assert p.gaps == [(61.0, 34.0), (47.0, 13.0), (0.0, 10.0)]  # ties: earliest first
    report = profile_decode.format_profile(p, "TM8192 cuda_layered")
    assert "device busy 33.0%" in report and "k2" in report


def test_profile_aggregate_default_window_and_nesting():
    """Without a window it spans the events; a nested interval adds no
    busy time; no events is an error."""
    p = profile_decode.aggregate([("a", 0, 10), ("b", 2, 4), ("a", 12, 20)], gaps=5)
    assert p.window == (0.0, 20.0)
    assert p.busy == pytest.approx(18 / 20)
    assert p.gaps == [(10.0, 2.0)]
    with pytest.raises(ValueError):
        profile_decode.aggregate([])


def test_profile_decode_raises_without_device_activity():
    """On the CPU the profiler records no CUDA event: profile_decode says so
    and raises instead of timing another way."""
    with pytest.raises(profile_decode.NoDeviceActivity, match="no CUDA activity"):
        profile_decode.profile_decode("TC128", "cuda_layered", torch.float32, batch=8, reps=1,
                                      device="cpu")
    with pytest.raises(profile_decode.NoDeviceActivity):
        profile_decode.profile_decode("TC128", "bf_cuda", batch=8, reps=1, device="cpu")
