"""The port's quality tools (labrador_ldpc_tpu_torch/tools/) against the JAX
package's tools/gen_*.py, on the CPU.

The JAX tools are loaded from their files and run with the JAX `waterfall`
replaced, in the test only, by a recorder that answers each call with
deterministic points from a fixed FER model; their output globals point
into `tmp_path`, so nothing is written into benchmarks/results/. The port's
modules run the same way with their own `waterfall` replaced. Held equal:
the sequence of waterfall calls (each JAX impl mapped to its port impl, as
the tools' package docstring says) and the data rows of every table. The
walkers are held to the JAX `cross_db` on synthetic FER functions, the
comparator to cases of known outcome, and each generator runs once for real
here (TC128 or TC512, each waterfall call cut to one batch of 64) into a
file the comparator reads as it reads the TPU's. No JAX decoder runs. Tolerance: exact throughout.
"""

import importlib
import importlib.util
import math
import sys
from pathlib import Path

import jax
import pytest
import torch

from labrador_ldpc_tpu_torch.channel.waterfall import SnrPoint
from labrador_ldpc_tpu_torch.tools import TPU_RESULTS, Run, compare
from labrador_ldpc_tpu_torch.tools import (
    gen_ber_anchors,
    gen_bf_curves,
    gen_bsc_thresholds,
    gen_gap_table,
    gen_sp_gap,
)

# the module: `labrador_ldpc_tpu.channel` binds the name `waterfall` to the function
jwaterfall = importlib.import_module("labrador_ldpc_tpu.channel.waterfall")
REPO = Path(__file__).resolve().parents[1]
PORT = {"gen_ber_anchors": gen_ber_anchors, "gen_bf_curves": gen_bf_curves,
        "gen_bsc_thresholds": gen_bsc_thresholds, "gen_gap_table": gen_gap_table,
        "gen_sp_gap": gen_sp_gap}
# each JAX impl and the port impl bit-exact to the same twin on a card
IMPL_MAP = {"qc": "cuda_qc", "pallas_qc": "cuda_qc", "pallas_layered": "cuda_layered",
            "sp_pallas": "cuda_sp"}
K = gen_bsc_thresholds.K


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run PyTorch's CPU ops on one thread (tests/test_torch_layered.py)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def jax_tools(monkeypatch):
    """load(name): tools/<name>.py as a fresh module (gen_gap_table also
    registered under its own name, as the sibling tools import it), with the
    jax.config settings the tools change at import put back afterwards."""
    keys = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}

    def load(name):
        if name != "gen_gap_table" and "gen_gap_table" not in sys.modules:
            monkeypatch.setitem(sys.modules, "gen_gap_table", load("gen_gap_table"))
        spec = importlib.util.spec_from_file_location(name, REPO / "tools" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        if name == "gen_gap_table":
            monkeypatch.setitem(sys.modules, name, mod)
        return mod

    monkeypatch.delitem(sys.modules, "gen_gap_table", raising=False)
    yield load
    for k, v in saved.items():
        jax.config.update(k, v)


def fer_model(code, decoder, impl, noise_model, x) -> float:
    """A fixed FER: falling with dB, rising with p, per code and surface."""
    if noise_model in ("bsc", "bec"):
        return min(0.9, 0.05 * (x / gen_bsc_thresholds.P_START_BF[code]) ** 3)
    shift = {"ms": 0.4, "ms_hard": 2.3, "bf": 4.1}[decoder] + {"sp": 0.3, "cuda_qc": 0.5}.get(
        IMPL_MAP.get(impl, impl), 0.0)
    return min(0.9, 0.3 * 10 ** (-1.3 * (x - gen_gap_table.MS_START[code] - shift)))


def recorder(point_type, calls: list):
    """A stand-in for `waterfall`: records each call, answers from fer_model
    with the bits and bit-error budgets applied batch by batch."""

    def waterfall(code, snrs, batch=1024, maxiters=100, max_bits=50_000_000,
                  max_bit_errors=5_000, noise_model="perftest", dtype_name="float32",
                  impl="auto", seed=0, decoder="ms", **_):
        calls.append((code, tuple(snrs), batch, maxiters, max_bits, max_bit_errors, noise_model,
                      decoder, seed, IMPL_MAP.get(impl, impl), dtype_name))
        k = K[code]
        out = []
        for x in snrs:
            fer = fer_model(code, decoder, impl, noise_model, x)
            steps_max = max(1, -(-max_bits // (batch * k)))
            per_batch = max(1, round(7 * fer * batch))
            steps = min(steps_max, -(-max_bit_errors // per_batch))
            trials = steps * batch
            fe = round(fer * trials)
            out.append(point_type(code=code, snr_db=x, trials=trials, bits=trials * k,
                                  bit_errors=7 * fe, frame_errors=fe, elapsed_s=1e-3 * steps))
        return out

    return waterfall


def data_rows(path: Path) -> list[str]:
    return [line for line in path.read_text().splitlines() if line and not line.startswith("#")]


def run_jax(load, name, switch, out: Path, monkeypatch, calls):
    mod = load(name)
    rec = recorder(jwaterfall.SnrPoint, calls)
    monkeypatch.setattr(jwaterfall, "waterfall", rec)
    if name == "gen_ber_anchors":
        monkeypatch.setattr(mod, "waterfall", rec)
        for attr in ("OUT", "OUT_I8", "OUT_I16", "OUT_I8_FLOOD", "OUT_I16_FLOOD", "OUT_SP"):
            monkeypatch.setattr(mod, attr, out / getattr(mod, attr).name)
        run = {None: mod.main, "--sp": mod.main_sp,
               "--i8": lambda: mod.main_int(8, False), "--i16": lambda: mod.main_int(16, False),
               "--i8-flooding": lambda: mod.main_int(8, True),
               "--i16-flooding": lambda: mod.main_int(16, True)}[switch]
        run()
        return
    monkeypatch.setattr(mod, "RESULTS", out)
    monkeypatch.setattr(sys, "argv", [f"{name}.py"] + ([switch] if switch else []))
    mod.main()


CASES = [("gen_gap_table", None), ("gen_bsc_thresholds", None), ("gen_sp_gap", None),
         ("gen_bf_curves", None)] + [
    ("gen_ber_anchors", s) for s in (None, "--i8", "--i16", "--i8-flooding", "--i16-flooding",
                                     "--sp")]


@pytest.mark.parametrize("name,switch", CASES)
def test_same_calls_same_rows(name, switch, jax_tools, monkeypatch, tmp_path):
    """The port's generator makes the JAX tool's waterfall calls, impls
    mapped, in the same order, and writes the same data rows (gen_bf_curves:
    its deep and --quick job lists)."""
    switches = ["--quick", None] if name == "gen_bf_curves" else [switch]
    for sw in switches:
        jax_out, port_out = tmp_path / f"tpu{sw}", tmp_path / f"card{sw}"
        jax_out.mkdir()
        jax_calls, port_calls = [], []
        run_jax(jax_tools, name, sw, jax_out, monkeypatch, jax_calls)
        mod = PORT[name]
        # gen_sp_gap's probes are gen_gap_table's fer_at
        monkeypatch.setattr(gen_gap_table if name == "gen_sp_gap" else mod, "waterfall",
                            recorder(SnrPoint, port_calls))
        mod.main(([sw] if sw else []) + ["--device", "cpu", "--out-dir", str(port_out)])
        assert port_calls == jax_calls and jax_calls
        assert {c[9] for c in port_calls} <= {"auto", "sp", "cuda_qc", "cuda_layered", "cuda_sp"}
        written = sorted(p.name for p in jax_out.glob("*.csv"))
        assert written and written == sorted(p.name for p in port_out.glob("*.csv"))
        for f in written:
            assert data_rows(port_out / f) == data_rows(jax_out / f), f
            assert set(written) <= set(compare.tables())


def synthetic(kind):
    """(fer_fn, cross_db keyword arguments) of a walk case; fer_fn records
    each probe (x, trials) into .probes."""
    probes = []

    def fer_fn(code, surface, x, trials, points_log):
        probes.append((x, trials))
        points_log.append(f"{x},{trials}")
        if kind == "zero_errors" and x >= 3.0:
            return 0.0 if len([p for p in probes if p[0] == x]) == 1 else 4e-4
        if kind == "multiplicative":
            return min(0.5, (x / 0.01) ** 4 * 0.02)
        return min(0.8, 0.3 * 10 ** (-0.9 * (x - 1.0)))

    kw = {}
    if kind == "multiplicative":
        kw = dict(start=0.03, advance=lambda v: v * 0.82, retreat=lambda v: v / 0.82**4,
                  interp=lambda x0, x1, t: math.exp(math.log(x0) + t * (math.log(x1)
                                                                      - math.log(x0))))
    elif kind == "below_target":
        kw = dict(start=5.0)
    fer_fn.probes = probes
    return fer_fn, kw


@pytest.mark.parametrize("kind", ["zero_errors", "multiplicative", "below_target"])
def test_same_walker(kind, jax_tools):
    """cross_db gives the JAX cross_db's probes (point and trials) and crossing:
    the additive axis with a point that shows no errors until its 8x
    re-measure, the multiplicative axis, and a start below the target."""
    jmod = jax_tools("gen_gap_table")
    out = []
    for walker in (jmod.cross_db, gen_gap_table.cross_db):
        fer_fn, kw = synthetic(kind)
        log = []
        x = walker("TC512", "ms", 1e-3, log, fer_fn=fer_fn, **kw)
        out.append((x, fer_fn.probes, log))
    assert out[0] == out[1]
    if kind == "zero_errors":
        assert any(t2 == 8 * t1 for (x1, t1), (x2, t2) in zip(out[1][1], out[1][1][1:])
                   if x1 == x2)


def table(path: Path, name: str, columns: str, rows: list[str]) -> Path:
    path.mkdir(parents=True, exist_ok=True)
    (path / name).write_text(f"# test table\n# Columns: {columns}\n" + "\n".join(rows) + "\n")
    return path


ANCHOR_COLUMNS = "code,snr_db,trials,data_bits,bit_errors,ber,noise_model,frame_errors"


def anchor_pair(tmp_path, e_card, e_tpu, n=8192):
    name = "ber_regression_points_i8.csv"
    row = "TM8192,1.1,{n},{bits},{be},1e-3,ebn0,{fe}"
    card = table(tmp_path / "card", name, ANCHOR_COLUMNS,
                 [row.format(n=n, bits=n * 4096, be=7 * e_card, fe=e_card)])
    tpu = table(tmp_path / "tpu", name, ANCHOR_COLUMNS,
                [row.format(n=n, bits=n * 4096, be=7 * e_tpu, fe=e_tpu)])
    (pair,), unpaired = compare.compare_files(card / name, tpu / name)
    assert unpaired == 0
    rc = compare.main(["--card-dir", str(card), "--tpu-dir", str(tpu)])
    return pair, rc


def test_compare_stored_tables(capsys):
    """The TPU's tables compared with themselves pass, every pair gated where
    it should be; the card's committed tables (labrador_ldpc_tpu_torch/results/,
    one per TPU table) pass against the TPU's."""
    assert compare.main(["--card-dir", str(TPU_RESULTS), "--tpu-dir", str(TPU_RESULTS)]) == 0
    summary = capsys.readouterr().out.strip().splitlines()[-1]
    assert summary.startswith(f"compare: {len(compare.tables())} files; 700 gated pairs "
                              "(643 points, 39 dB crossings, 18 p* crossings), 700 passed, 0 "
                              "failed")
    assert compare.main([]) == 0
    summary = capsys.readouterr().out.strip().splitlines()[-1]
    assert summary.startswith(f"compare: {len(compare.tables())} files;")
    assert ", 0 failed;" in summary


def test_compare_fails_a_gross_shift(tmp_path):
    """3261 frame errors against 168 at 8192 trials each (a clipped int
    posterior) fails."""
    pair, rc = anchor_pair(tmp_path, 3261, 168)
    assert pair.gated and not pair.ok and rc == 1


def test_compare_passes_sampling_noise(tmp_path):
    pair, rc = anchor_pair(tmp_path, 540, 500)
    assert pair.gated and pair.ok and rc == 0
    assert compare.rate_test(540, 8192, 500, 8192) > 0.1


def test_compare_does_not_gate_a_tail_pair(tmp_path):
    """Both sides under 20 frame errors: printed, not gated, even 19 against
    0 (p = 3.8e-6); 20 against 0 is gated and fails."""
    pair, rc = anchor_pair(tmp_path, 19, 0)
    assert not pair.gated and rc == 0
    pair, rc = anchor_pair(tmp_path / "20", 20, 0)
    assert pair.gated and not pair.ok and rc == 1


def test_compare_fails_a_crossing_off_by_0_2_db(tmp_path):
    name = "bf_ms_gap_table.csv"
    cols = "code,fer_target,bf_db,ms_hard_db,ms_db,delta_total_db,delta_alg_db,delta_hard_db"
    tpu = table(tmp_path / "tpu", name, cols, ["TM8192,0.001,8.83,2.91,1.25,7.58,5.92,1.66"])
    near = table(tmp_path / "near", name, cols, ["TM8192,0.001,8.93,2.81,1.35,7.58,6.12,1.46"])
    far = table(tmp_path / "far", name, cols, ["TM8192,0.001,8.83,2.91,1.45,7.38,5.92,1.46"])
    assert compare.main(["--card-dir", str(near), "--tpu-dir", str(tpu)]) == 0
    assert compare.main(["--card-dir", str(far), "--tpu-dir", str(tpu)]) == 1
    pairs, _ = compare.compare_files(far / name, tpu / name)
    assert [(p.key, p.ok) for p in pairs] == [
        ("TM8192/bf_db", True), ("TM8192/ms_hard_db", True), ("TM8192/ms_db", False)]


def capped(k_of, real):
    """`waterfall` cut to one batch of 64 a point (the tiny real run)."""

    def waterfall(code, snrs, batch, maxiters, max_bits, **kw):
        return real(code, snrs, batch=64, maxiters=maxiters,
                    max_bits=min(max_bits, 64 * k_of[code]), **kw)

    return waterfall


@pytest.mark.parametrize("name,argv", [
    ("gen_gap_table", ["--codes", "TC128"]),
    ("gen_bsc_thresholds", ["--codes", "TC128"]),
    ("gen_sp_gap", ["--codes", "TC128"]),
    ("gen_ber_anchors", None),
    ("gen_bf_curves", ["--only", "tc512_bsc"]),
])
def test_tiny_run_parses_like_the_tpu_table(name, argv, monkeypatch, tmp_path):
    """One real run on the CPU, each waterfall call cut to one batch of 64:
    each table it writes has the TPU table's columns, names the command,
    and the comparator pairs its rows with the TPU's."""
    mod = PORT[name]
    owner = gen_gap_table if name == "gen_sp_gap" else mod
    monkeypatch.setattr(owner, "waterfall", capped(K, owner.waterfall))
    if argv is None:  # the TC128 f32 anchors
        gen_ber_anchors.anchors(Run(device="cpu"), tmp_path, ["(test)"],
                                grid=gen_ber_anchors.GRID[:1])
    else:
        mod.main(argv + ["--device", "cpu", "--out-dir", str(tmp_path)])
    written = sorted(p.name for p in tmp_path.glob("*.csv"))
    assert written and set(written) <= set(compare.tables())
    for f in written:
        cols, rows = compare.read_table(tmp_path / f)
        assert cols == compare.read_table(TPU_RESULTS / f)[0] and rows
        assert all(len(r) == len(cols) for r in rows)
        text = (tmp_path / f).read_text()
        assert "# command: python -m labrador_ldpc_tpu_torch.tools." in text
        assert str(tmp_path) not in text  # the command is shown without its --out-dir
    pairs, files, unpaired = compare.compare_dirs(tmp_path, TPU_RESULTS)
    assert files == [f for f in compare.tables() if f in written] and pairs


def test_out_dir_guard():
    """Every generator refuses benchmarks/results, the TPU's record, before
    it runs anything, and leaves it as it was."""
    before = {p.name: p.stat().st_mtime_ns for p in TPU_RESULTS.iterdir()}
    for mod in PORT.values():
        with pytest.raises(ValueError, match="TPU's tables"):
            mod.main(["--device", "cpu", "--out-dir", str(TPU_RESULTS)])
        with pytest.raises(ValueError, match="TPU's tables"):
            mod.main(["--device", "cpu", "--out-dir", str(REPO / "benchmarks" / "." / "results")])
    assert {p.name: p.stat().st_mtime_ns for p in TPU_RESULTS.iterdir()} == before
