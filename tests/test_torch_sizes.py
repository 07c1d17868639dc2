"""The port's H100 launch table (ops/routing.py), its memory tables
(sizes.py, `python -m labrador_ldpc_tpu_torch sizes`), the pipelined slope
(utils/timing.py) and the serving loop (serve.py), on the CPU.

`ROUTES` below pins every launch shape that the four kernels' `launch_config`
functions compute, for every code and dtype form, and `route_for` must give
them; a change of a footprint fails here until its row is updated. A code
a kernel cannot take fails in `route_for`, in every kernel's decoder factory,
before any launch, and in `decoder_memory`. The memory rows are pinned by
hand for TM8192 and TC128 (the layered float32 and bit-flip shared bytes
recorded in PERF.md).
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
from labrador_ldpc_tpu_torch.ops import card, cuda_bf, cuda_layered, cuda_qc, cuda_sp, routing
from labrador_ldpc_tpu_torch.ops.routing import Check, Forms, KernelRoute, Lanes
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


# every kernel's launch shape on an H100, per code: threads, checks a thread
# (lanes and codewords a CTA for the bit-flip kernel) and dynamic shared bytes
ROUTES = {
    "TC128": KernelRoute(
        layered=Forms(Check(32, 1, 3112), Check(32, 1, 1576), Check(32, 1, 1192),
                      Check(32, 1, 1832)),
        flooding=Forms(Check(32, 1, 2048), Check(32, 1, 1536), Check(32, 1, 1280),
                       Check(32, 1, 1536)),
        sumproduct=Check(32, 1, 2560),
        bitflip=Lanes(256, 4, 64, 9528)),
    "TC256": KernelRoute(
        layered=Forms(Check(32, 1, 6192), Check(32, 1, 3120), Check(32, 1, 2352),
                      Check(32, 1, 3632)),
        flooding=Forms(Check(32, 1, 4096), Check(32, 1, 3072), Check(32, 1, 2560),
                       Check(32, 1, 3072)),
        sumproduct=Check(32, 1, 5120),
        bitflip=Lanes(256, 4, 64, 9528)),
    "TC512": KernelRoute(
        layered=Forms(Check(32, 2, 12384), Check(32, 2, 6240), Check(32, 2, 4704),
                      Check(32, 2, 7264)),
        flooding=Forms(Check(64, 1, 8192), Check(64, 1, 6144), Check(64, 1, 5120),
                       Check(64, 1, 6144)),
        sumproduct=Check(64, 1, 10240),
        bitflip=Lanes(256, 8, 32, 9784)),
    "TM1280": KernelRoute(
        layered=Forms(Check(128, 1, 28896), Check(64, 2, 14560), Check(32, 4, 11616),
                      Check(64, 2, 17376)),
        flooding=Forms(Check(128, 1, 21248), Check(128, 1, 15616), Check(128, 1, 12800),
                       Check(128, 1, 15616)),
        sumproduct=Check(128, 1, 25600),
        bitflip=Lanes(256, 16, 16, 13344)),
    "TM1536": KernelRoute(
        layered=Forms(Check(128, 2, 37184), Check(64, 4, 18752), Check(64, 4, 14912),
                      Check(64, 4, 22336)),
        flooding=Forms(Check(256, 1, 26112), Check(256, 1, 18944), Check(256, 1, 15360),
                       Check(256, 1, 18944)),
        sumproduct=Check(256, 1, 30720),
        bitflip=Lanes(256, 32, 8, 9456)),
    "TM2048": KernelRoute(
        layered=Forms(Check(256, 2, 53760), Check(128, 4, 27136), Check(128, 4, 21504),
                      Check(128, 4, 32256)),
        flooding=Forms(Check(256, 2, 35840), Check(256, 2, 25600), Check(256, 2, 20480),
                       Check(256, 2, 25600)),
        sumproduct=Check(256, 2, 40960),
        bitflip=Lanes(256, 32, 8, 13736)),
    "TM5120": KernelRoute(
        layered=Forms(Check(512, 1, 115584), Check(256, 2, 58240), Check(256, 2, 46464),
                      Check(256, 2, 69504)),
        flooding=Forms(Check(512, 1, 84992), Check(512, 1, 62464), Check(512, 1, 51200),
                       Check(512, 1, 62464)),
        sumproduct=Check(512, 1, 102400),
        bitflip=Lanes(256, 32, 8, 29120)),
    "TM6144": KernelRoute(
        layered=Forms(Check(1024, 1, 148736), Check(256, 4, 75008), Check(256, 4, 59648),
                      Check(512, 2, 89344)),
        flooding=Forms(Check(1024, 1, 104448), Check(1024, 1, 75776), Check(1024, 1, 61440),
                       Check(1024, 1, 75776)),
        sumproduct=Check(1024, 1, 122880),
        bitflip=Lanes(256, 32, 8, 37680)),
    "TM8192": KernelRoute(
        layered=Forms(Check(1024, 2, 215040), Check(512, 4, 108544), Check(512, 4, 86016),
                      Check(1024, 2, 129024)),
        flooding=Forms(Check(1024, 2, 143360), Check(1024, 2, 102400), Check(1024, 2, 81920),
                       Check(1024, 2, 102400)),
        sumproduct=Check(1024, 2, 163840),
        bitflip=Lanes(256, 32, 8, 54824)),
}


def test_every_code_routed():
    """Every code has a pinned row, and its route is built once."""
    assert list(ROUTES) == [c.value for c in T.ALL_CODES]
    for c in T.ALL_CODES:
        assert routing.route_for(c) is routing.route_for(c)


@pytest.mark.parametrize("name", [c.value for c in T.ALL_CODES])
def test_routes_equal_launch_config(name):
    """Each kernel's launch_config and route_for give the pinned row."""
    r = ROUTES[name]
    for dtype, form in cuda_layered.FORMS.items():
        for forms, mod in ((r.layered, cuda_layered), (r.flooding, cuda_qc)):
            cfg = mod.launch_config(name, dtype)
            got = Check(cfg["threads"], cfg["checks_per_thread"], cfg["smem_bytes"])
            assert got == getattr(forms, form), (mod.__name__, form)
    cfg = cuda_sp.launch_config(name)
    assert Check(cfg["threads"], cfg["checks_per_thread"], cfg["smem_bytes"]) == r.sumproduct
    cfg = cuda_bf.launch_config(name)
    assert Lanes(cfg["threads"], cfg["lanes"], cfg["codewords_per_cta"],
                 cfg["smem_bytes"]) == r.bitflip
    assert routing.route_for(name) == r


def test_untakeable_code_fails_before_any_launch(monkeypatch):
    """With one CTA's shared memory below TM8192's smallest footprint (the
    bit-flip kernel's), the code fails with the shared-memory ValueError in
    route_for, in every kernel's decoder factory (before anything launches)
    and in decoder_memory for every kernel."""
    kernels = (cuda_layered, cuda_qc, cuda_sp, cuda_bf)
    launches = [mod.launches for mod in kernels]
    routing.route_for.cache_clear()
    monkeypatch.setattr(card, "CTA_SHARED_MAX", ROUTES["TM8192"].bitflip.smem_bytes - 1)
    builds = [routing.route_for]
    builds += [lambda c, f=f: f(c, device="cpu") for f in (
        T.make_ms_decoder_cuda_layered, T.make_ms_decoder_cuda_qc, T.make_sp_decoder_cuda,
        T.make_bf_decoder_cuda)]
    builds += [lambda c, i=i: sizes.decoder_memory(c, i) for i in sizes.IMPLS]
    for build in builds:
        with pytest.raises(ValueError, match=r"TM8192 needs \d+ B of shared memory, over 54823"):
            build("TM8192")
    assert [mod.launches for mod in kernels] == launches


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
    assert r.resident_codewords == r.ctas_per_sm * card.H100_SMS * r.codewords_per_cta


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
