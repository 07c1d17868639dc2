"""The port's H100 launch table (ops/routing.py), its memory tables
(sizes.py, `python -m labrador_ldpc_tpu_torch sizes`), the pipelined slope
(utils/timing.py) and the serving loop (serve.py), on the CPU.

`ROUTES` pins what the four kernels' `launch_config` functions compute, and
must equal them for every code and dtype form; `route_for` fails loudly for
a code without a row, and so does every kernel's decoder factory, before any
launch. The memory rows are pinned by hand for TM8192 and TC128 (the
layered float32 and bit-flip shared bytes recorded in PERF.md).
Tolerance: exact.
"""

import math
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from labrador_ldpc_tpu.sizes import format_reference_table as jformat_reference_table

import labrador_ldpc_tpu_torch as T
from labrador_ldpc_tpu_torch import sizes
from labrador_ldpc_tpu_torch.ops import cuda_bf, cuda_layered, cuda_qc, cuda_sp, routing
from labrador_ldpc_tpu_torch.serve import serve
from labrador_ldpc_tpu_torch.utils.timing import pipelined_slope

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run PyTorch's CPU ops on one thread (tests/test_torch_layered.py)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_every_code_routed():
    assert list(routing.ROUTES) == [c.value for c in T.ALL_CODES]


@pytest.mark.parametrize("name", [c.value for c in T.ALL_CODES])
def test_routes_equal_launch_config(name):
    """Each row is what the kernels' launch_config functions compute."""
    r = routing.route_for(name)
    for dtype, form in cuda_layered.FORMS.items():
        for forms, mod in ((r.layered, cuda_layered), (r.flooding, cuda_qc)):
            cfg = mod.launch_config(name, dtype)
            want = routing.Check(cfg["threads"], cfg["checks_per_thread"], cfg["smem_bytes"])
            assert getattr(forms, form) == want, (mod.__name__, form)
    cfg = cuda_sp.launch_config(name)
    assert r.sumproduct == routing.Check(cfg["threads"], cfg["checks_per_thread"],
                                         cfg["smem_bytes"])
    cfg = cuda_bf.launch_config(name)
    assert r.bitflip == routing.Lanes(cfg["threads"], cfg["lanes"], cfg["codewords_per_cta"],
                                      cfg["smem_bytes"])


def test_unrouted_code_fails_loudly(monkeypatch):
    """A code without a row raises KeyError naming the remedy, in route_for,
    in every kernel's decoder factory (before anything launches) and in
    decoder_memory."""
    monkeypatch.delitem(routing.ROUTES, "TM8192")
    for build in (routing.route_for, T.make_ms_decoder_cuda_layered, T.make_ms_decoder_cuda_qc,
                  T.make_sp_decoder_cuda, T.make_bf_decoder_cuda, sizes.decoder_memory):
        kw = {} if build in (routing.route_for, sizes.decoder_memory) else {"device": "cpu"}
        with pytest.raises(KeyError, match="never borrowed from another code"):
            build("TM8192", **kw)


@pytest.mark.parametrize("code,impl,dtype,want", [
    # threads, codewords/CTA, shared/CTA, shared/cw, CTAs/SM at 64 registers,
    # B/cw/decode, device bytes of a decode of 16384 (the layered tables: the
    # descriptors, the offsets and 15 x 64 syndrome windows)
    ("TM8192", "cuda_layered", torch.float32,
     (1024, 1, 215040, 215040, 1, 8192 * 4 + 10240 + 5, 16384 * 43013 + 4 * (30 + 4 + 960))),
    ("TM8192", "cuda_layered", torch.int8,
     (512, 1, 86016, 86016, 2, 8192 + 10240 + 5, 16384 * 18437 + 4 * (30 + 4 + 960))),
    ("TM8192", "cuda_qc", torch.bfloat16,
     (1024, 1, 102400, 102400, 1, 8192 * 2 + 10240 + 5, 16384 * 26629 + 4 * (30 + 4 + 15))),
    ("TM8192", "cuda_sp", torch.float32,
     (1024, 1, 163840, 163840, 1, 43013, 16384 * 43013 + 4 * (30 + 4))),
    ("TM8192", "cuda_bf", None,
     (256, 8, 54824, 5888, 4, 8192 + 10240 + 5, 16384 * 18437 + 7720 + 4)),
    ("TC128", "cuda_layered", torch.float32,
     (32, 1, 3112, 3112, 32, 128 * 4 + 128 + 5, 16384 * 645 + 4 * (2 * 32 + 5 + 32))),
    ("TC128", "cuda_bf", None, (256, 64, 9528, 144, 4, 128 + 128 + 5, None)),
])
def test_decoder_memory_pinned(code, impl, dtype, want):
    """Rows pinned by hand: TM8192 layered float32 holds 215,040 shared bytes
    a codeword, bit-flip 5,888 a codeword and 54,824 a CTA."""
    r = sizes.decoder_memory(code, impl, dtype or torch.float32)
    got = (r.threads, r.codewords_per_cta, r.smem_bytes_per_cta, r.smem_bytes_per_cw,
           r.ctas_per_sm, r.bytes_per_cw, r.alloc_bytes)
    if want[-1] is None:
        got, want = got[:-1], want[:-1]
    assert got == want
    assert r.resident_codewords == r.ctas_per_sm * sizes.H100_SMS * r.codewords_per_cta


def test_ctas_per_sm_follow_the_registers():
    """CTAs per SM are counted at the given registers: at the budget (64)
    they are launch_config's; fewer registers never give fewer CTAs."""
    for code in T.ALL_CODES:
        for dtype in cuda_layered.FORMS:
            cfg = cuda_layered.launch_config(code, dtype)
            assert sizes.decoder_memory(code, "cuda_layered", dtype).ctas_per_sm == \
                cfg["ctas_per_sm"]
        bf = sizes.decoder_memory(code, "cuda_bf")
        assert bf.ctas_per_sm == cuda_bf.launch_config(code)["ctas_per_sm"]
        assert sizes.decoder_memory(code, "cuda_bf", registers=38).ctas_per_sm >= bf.ctas_per_sm
    assert sizes.decoder_memory("TC512", "cuda_sp", registers=32).ctas_per_sm == \
        cuda_sp.launch_config("TC512", registers=32)["ctas_per_sm"]


def test_memory_table_and_refusals():
    rows = sizes.memory_table()
    assert len(rows) == len(T.ALL_CODES) * (2 * len(cuda_layered.FORMS) + 2)
    assert all(r.batch == 16384 and r.alloc_bytes > r.batch * r.bytes_per_cw for r in rows)
    with pytest.raises(ValueError, match="unknown impl"):
        sizes.decoder_memory("TM8192", "pallas_layered")
    with pytest.raises(ValueError, match="float32"):
        sizes.decoder_memory("TM8192", "cuda_sp", torch.int8)
    with pytest.raises(ValueError):
        sizes.decoder_memory("TM8192", "cuda_layered", torch.float64)


def test_sizes_cli_prints_both_tables():
    """`python -m labrador_ldpc_tpu_torch sizes` prints the H100 table and the
    reference crate's RAM table, the JAX package's to the character."""
    out = subprocess.run([sys.executable, "-m", "labrador_ldpc_tpu_torch", "sizes"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert sizes.format_memory_table() in out.stdout
    assert out.stdout.rstrip().endswith(jformat_reference_table())
    assert "| TM8192 | cuda_bf | u8-bits | 256 | 8 | 53.5 KiB | 5,888 | 4 (64) |" in out.stdout


def test_pipelined_slope_recovers_a_known_slope():
    """On a fake clock where a train of c dispatches takes 0.25 + 0.004 c
    seconds, the slope is 0.004 whatever the constant cost."""
    now = [0.0]

    def clock():
        return now[0]

    def fn(x):
        now[0] += 0.004
        return x

    def sync(out):
        now[0] += 0.25

    assert pipelined_slope(fn, 1, sync, k=32, reps=2, clock=clock) == pytest.approx(0.004)


def test_serve_loop_on_cpu():
    """The serving loop checks every frame; on the CPU at a tiny size it
    runs the plain layered decoder, synchronously."""
    r = serve(6, "TC128", 16, slope_k=4, device="cpu")  # 6 batches: 4 in flight, drained
    assert (r.frames, r.failures, r.wrong) == (96, 0, 0)
    assert r.dispatches == 1 + 6 + 3 * (1 + 2 + 3 + 4)
    assert r.seconds > 0 and math.isfinite(r.dispatch_s)
