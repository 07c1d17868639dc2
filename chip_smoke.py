"""Drive the PyTorch + CUDA port's main path on one NVIDIA H100 and check it.

    python3 chip_smoke.py

Needs one CUDA card, nvcc (CUDA_HOME, PATH or /usr/local/cuda) and the
repository checkout: it imports labrador_ldpc_tpu_torch and nothing of the
JAX package, and reads the CCSDS golden parity from tests/golden_vectors.py
(plain data). Every phase is fatal on failure; nothing is caught.

  1. build every CUDA source of the port with nvcc, all at once;
  2. print the card's name and power limit (nvidia-smi);
  3. encoder on the card against the golden CCSDS parity of all nine codes;
  4. the layered min-sum kernel against its plain PyTorch version on the
     card, all nine codes, noisy LLRs where some frames fail (B=256,
     maxiters=20), plus alpha=0.8 and maxiters 0/1 cases: identical bits,
     success and iterations;
  5. the main path: 8 serving batches of TM8192, B=16384, 3 flipped bits in
     byte 0, maxiters=50, through encode -> hard_to_llrs -> decode_ms
     (impl="auto"), every frame's data verified; launch counts are reset
     just before and read just after;
  6. TM8192 at 1.0 dB, B=256, maxiters=50 (deep iterations and failures):
     kernel against plain version, bit for bit;
  7. times (CUDA events) of each kernel and of its plain version at its
     path's shapes, and each kernel's bound: the layered kernel as above,
     the bit-flip kernel at TM8192, B=16384, maxiters=50 on the 3-flip
     batch of phase 5 (the decode_bf protocol, benches/decode.rs:22-37), on
     a BSC(p=0.006) batch where failing frames run deep, and at TM1536 on
     3 flips;
  8. the bit-flip kernel against its plain PyTorch version on the card, all
     nine codes (B=256, 1-6 flips plus heavy corruption on half the batch,
     maxiters=20), clean codewords, maxiters 0 and 1, odd batch sizes, and
     once against the plain version on the CPU: identical bits, success and
     iterations;
  9. the hard-decision slice's path: `waterfall(..., device="cuda")` at
     TM8192, batch 8192, one batch per point, bit-flip over Eb/N0 6.5 dB,
     BSC 0.006 and BEC 0.012 and soft min-sum at 1.0 dB, each point's frame
     errors within a factor 2 of the stored curve (benchmarks/results);
     launch counts are reset just before and read just after; then the
     stage times (CUDA events) of one bit-flip and one min-sum batch.
Then one JSON line `{"kernels": [...]}`; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import csv
import importlib.util
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s and float32
# operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# float32 operations per edge and iteration in csrc/layered_minsum.cu:
# 12 in pass 1 (sub, 3 compares, select, abs, compare, 2 mins, select,
# sign compare and xor counted as one), 7 in pass 2 (abs, compare, select,
# sign compare, negate-select, sub, add), 1 in the syndrome; alpha adds 1
OPS_PER_EDGE_ITER = 20
# integer operations in csrc/bitflip.cu, counted from the source: per edge
# and iteration 5 in the parity sweep (kind test, add, mask of a rotation's
# perm_index; address; xor) and 5 in the count sweep (the same for
# perm_inverse; add); per variable and iteration 3 (max, compare, xor); the
# erasure pass costs one parity sweep. A pi permutation's index costs more
# and loop counters are not counted, so this undercounts. The data-sheet
# peaks above give no integer rate: they are divided by the float32 rate
# outside the tensor cores (F32_OPS_PER_S), the SM's widest non-tensor pipe,
# so the bound is a lower bound.
BF_OPS_PER_EDGE_ITER = 10
BF_OPS_PER_VAR_ITER = 3
BF_OPS_ERASURE_PER_EDGE = 5

# Eb/N0 (dB) at which a batch partly converges at maxiters=20, per code
PARTIAL_EBN0 = {
    "TC128": 1.5, "TC256": 2.0, "TC512": 2.0, "TM1280": 3.0, "TM1536": 2.0,
    "TM2048": 1.5, "TM5120": 2.75, "TM6144": 2.0, "TM8192": 1.5,
}
FLIPS = (1 << 7) | (1 << 5) | (1 << 3)  # 3 bits of byte 0 (benches/decode.rs:52)

# the slice's path: (decoder, noise model, point, maxiters, stored curve); the
# curves were measured at batch 8192, seed 0 (benchmarks/results)
WATERFALL_POINTS = (
    ("bf", "ebn0", 6.5, 50, "waterfall_bf_tm8192_ebn0.csv"),
    ("bf", "bsc", 0.006, 50, "waterfall_bf_tm8192_bsc.csv"),
    ("bf", "bec", 0.012, 50, "waterfall_bf_tm8192_bec.csv"),
    ("ms", "ebn0", 1.0, 100, "waterfall_ms_tm8192_ebn0.csv"),
)
BAND = 2.0  # observed/stored frame errors in [1/BAND, BAND] (tests/test_ber_regression.py)


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def phase(name: str):
    print(f"== {name}", flush=True)


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    import labrador_ldpc_tpu_torch as T
    from labrador_ldpc_tpu_torch.channel.awgn import _count_stats, make_trial_step
    from labrador_ldpc_tpu_torch.channel.hard import make_bf_trial_step
    from labrador_ldpc_tpu_torch.codes.expand import qc_structure
    from labrador_ldpc_tpu_torch.ops import _nvcc, cuda_bf, cuda_layered
    from labrador_ldpc_tpu_torch.ops.bitflip import bitflip_plain
    from labrador_ldpc_tpu_torch.ops.qc_minsum import layered_minsum_plain

    dev = torch.device("cuda")

    # ---- 1. build -----------------------------------------------------------
    phase("1 build")
    t0 = time.perf_counter()
    sources = (cuda_layered.SOURCE, cuda_bf.SOURCE)
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per source, all at once
        builds = list(pool.map(_nvcc.build, sources))
    print(f"built in {time.perf_counter() - t0:.2f} s")
    for source, b in zip(sources, builds):
        print(f"  {source}: nvcc {b.seconds:.2f} s -> {b.path.name}")
        for line in b.log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"    {line.strip()}")
    cuda_layered._lib()  # load the libraries and declare the C signatures
    cuda_bf._lib()

    # ---- 2. card ------------------------------------------------------------
    phase("2 card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {kind}")

    # ---- 3. encoder -----------------------------------------------------------
    phase("3 encoder vs golden CCSDS parity")
    spec = importlib.util.spec_from_file_location("golden_vectors", ROOT / "tests" / "golden_vectors.py")
    golden = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(golden)
    for code in T.ALL_CODES:
        data = torch.arange(code.k // 8, dtype=torch.uint8, device=dev)[None]
        cw = T.encode(code, data)
        if cw.device.type != "cuda":
            fail(f"{code}: encode did not run on the card")
        if cw[0, code.k // 8 :].cpu().numpy().tobytes() != golden.GOLDEN_PARITY[code.value]:
            fail(f"{code}: parity differs from the golden CCSDS vector")
    print("golden parity: 9/9 codes")

    def noisy_llrs(code, batch, ebn0_db, seed):
        rng = np.random.default_rng(seed)
        data = rng.integers(0, 2, (batch, code.k), dtype=np.uint8)
        cw = T.encode_bits(code, data).cpu().numpy()
        sigma = np.sqrt(1.0 / (2.0 * code.k / code.n * 10.0 ** (ebn0_db / 10.0)))
        llrs = (1.0 - 2.0 * cw + sigma * rng.standard_normal(cw.shape)).astype(np.float32)
        return torch.from_numpy(llrs).to(dev)

    max_err = 0.0

    def max_diff(got, want) -> float:
        """Largest |difference| over bits, success and iterations."""
        return float(max(
            (got.bits.int() - want.bits.int()).abs().max().item(),
            (got.iterations - want.iterations).abs().max().item(),
            (got.success.int() - want.success.int()).abs().max().item(),
        ))

    def hold(label, code, llrs, maxiters, alpha=None):
        """Kernel vs plain version on the card, same inputs: identical."""
        nonlocal max_err
        got = cuda_layered.layered_minsum(code, llrs, maxiters, alpha)
        torch.cuda.synchronize()
        want = layered_minsum_plain(qc_structure(code), llrs, maxiters, alpha)
        err = max_diff(got, want)
        max_err = max(max_err, err)
        n_ok = int(want.success.sum())
        print(f"  {label:28s} B={llrs.shape[0]:5d} converged {n_ok:5d}  "
              f"mean iters {want.iterations.float().mean().item():6.2f}  max|diff| {err}")
        if err != 0:
            fail(f"{label}: kernel differs from its plain version")
        return got

    # ---- 4. kernel vs plain version, all nine codes ------------------------
    phase("4 layered kernel vs plain version, all nine codes")
    print("  tolerance: exact (the same float32 operations in the same order); max|diff| must be 0")
    for i, code in enumerate(T.ALL_CODES):
        llrs = noisy_llrs(code, 256, PARTIAL_EBN0[code.value], seed=40 + i)
        got = hold(f"{code} noisy", code, llrs, 20)
        if not 0 < int(got.success.sum()) < 256:
            fail(f"{code}: want a batch where some frames fail and some converge")
    for code, alpha in (("TM8192", 0.8), ("TC256", 0.8)):
        c = T.get_code(code)
        hold(f"{code} alpha={alpha}", c, noisy_llrs(c, 256, PARTIAL_EBN0[code] + 0.5, 7), 20, alpha)
    for code, maxiters in (("TM8192", 1), ("TM1280", 1), ("TM5120", 0)):
        c = T.get_code(code)
        hold(f"{code} maxiters={maxiters}", c, noisy_llrs(c, 64, PARTIAL_EBN0[code], 9), maxiters)
    # the card's plain version agrees with the CPU's (which the CPU tests pin
    # to the JAX twin)
    c = T.get_code("TM1536")
    llrs = noisy_llrs(c, 64, 2.0, 11)
    on_card = cuda_layered.layered_minsum(c, llrs, 20)
    on_cpu = layered_minsum_plain(qc_structure(c), llrs.cpu(), 20)
    if not all(torch.equal(a.cpu(), b) for a, b in zip(on_card, on_cpu)):
        fail("kernel on the card differs from the plain version on the CPU")
    print("  TM1536 kernel on the card == plain version on the CPU")

    # ---- 5. the main path ------------------------------------------------------
    phase("5 main path: TM8192 serving batches through decode_ms(impl='auto')")
    code = T.LDPCCode.TM8192
    B, n_batches, maxiters = 16384, 8, 50
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, 256, (B, code.k // 8), dtype=np.uint8) for _ in range(n_batches)]
    if T.resolve_impl(code, torch.float32, "auto") != "cuda_layered":
        fail("impl='auto' does not resolve to the CUDA kernel on the card")
    T.decode_ms(code, T.hard_to_llrs(T.encode(code, batches[0][:8])), maxiters=maxiters)  # warm
    torch.cuda.synchronize()
    cuda_layered.launches = 0
    stages = ("copy in", "encode", "corrupt+llrs", "decode", "verify")
    stage_ms = dict.fromkeys(stages, 0.0)
    t0 = time.perf_counter()
    frames = iters_sum = 0
    for data_np in batches:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(stages) + 1)]
        ev[0].record()
        data = torch.from_numpy(data_np).to(dev)
        ev[1].record()
        cw = T.encode(code, data)
        ev[2].record()
        cw[:, 0] ^= FLIPS
        llrs = T.hard_to_llrs(cw, torch.float32)
        ev[3].record()
        res = T.decode_ms(code, llrs, maxiters=maxiters, impl="auto")
        ev[4].record()
        decoded = T.pack_bits(res.bits[:, : code.k])
        ok = bool(res.success.all()) and torch.equal(decoded, data)
        ev[5].record()
        if not ok:
            fail("a serving frame did not decode to the data sent")
        frames += B
        iters_sum += int(res.iterations.sum())
        torch.cuda.synchronize()
        for i, name in enumerate(stages):
            stage_ms[name] += ev[i].elapsed_time(ev[i + 1])
    wall = time.perf_counter() - t0
    main_launches = cuda_layered.launches
    print(f"  {frames} frames verified in {wall:.3f} s ({frames / wall:.1f} frames/s end to end, "
          f"host data included); mean iteration of convergence {iters_sum / frames:.3f}")
    print(f"  per batch (CUDA events, mean of {n_batches}): " + ", ".join(
        f"{name} {ms / n_batches:.3f} ms" for name, ms in stage_ms.items()))
    print(f"  launches of layered_minsum_f32 on the main path: {main_launches}")
    if main_launches < 1:
        fail("the main path did not launch the CUDA kernel")

    # ---- 6. deep iterations -----------------------------------------------------
    phase("6 TM8192 at 1.0 dB, B=256, maxiters=50")
    got = hold("TM8192 1.0 dB", code, noisy_llrs(code, 256, 1.0, seed=3), 50)
    if not 0 < int(got.success.sum()) < 256:
        fail("want failures and successes at 1.0 dB")

    # ---- 7. times and bound -----------------------------------------------------
    phase("7 times at serving shapes (B=16384, maxiters=50)")

    def time_ms(fn, reps):
        fn()  # warm
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            out = fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps, out

    def measure(c, data_np):
        """Kernel and plain version in turns (plain, kernel, kernel, plain)
        on one serving batch of code c; returns the numbers of one row."""
        nonlocal max_err
        cw = T.encode(c, torch.from_numpy(data_np).to(dev))
        cw[:, 0] ^= FLIPS
        llrs = T.hard_to_llrs(cw, torch.float32)
        s = qc_structure(c)
        plain = lambda: layered_minsum_plain(s, llrs, maxiters)  # noqa: E731
        kern = lambda: cuda_layered.layered_minsum(c, llrs, maxiters)  # noqa: E731
        plain_a, want = time_ms(plain, 2)
        kern_a, got = time_ms(kern, 10)
        kern_b, _ = time_ms(kern, 10)
        plain_b, _ = time_ms(plain, 2)
        err = max_diff(got, want)
        max_err = max(max_err, err)
        if err != 0 or not bool(got.success.all()):
            fail(f"{c}: kernel differs from its plain version, or a frame failed")
        # work this data needs: a converged codeword ran iterations+1 sweeps,
        # a failed one maxiters
        sweeps = int(torch.where(got.success, got.iterations + 1, got.iterations).sum())
        p = c.params
        nb = data_np.shape[0]
        io_bytes = nb * p.n * 4 + nb * p.n_vars + nb + nb * 4
        ops = OPS_PER_EDGE_ITER * p.paritycheck_sum * sweeps
        bytes_ms, ops_ms = io_bytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
        state_bytes = 4 * p.paritycheck_sum * 4 * sweeps + io_bytes
        row = dict(
            ms=min(kern_a, kern_b), plain_ms=min(plain_a, plain_b),
            bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        )
        state_ms = state_bytes / HBM_BYTES_PER_S * 1e3
        print(f"  {c}: kernel {kern_a:.4f} / {kern_b:.4f} ms per decode -> "
              f"{nb / row['ms'] * 1e3:.1f} cw/s; plain {plain_a:.4f} / {plain_b:.4f} ms")
        print(f"  {c}: sweeps {sweeps} (mean {sweeps / nb:.3f} per codeword); in/out bytes "
              f"{io_bytes}; f32 ops {ops}; bound {row['bound_ms']:.4f} ms (bytes "
              f"{bytes_ms:.4f} ms, operations {ops_ms:.4f} ms)")
        print(f"  {c}: u/t' state traffic {state_bytes} B, computed from the shapes and "
              f"sweeps: {state_ms:.4f} ms at the assumed peak of {HBM_BYTES_PER_S:.3g} B/s "
              f"(not measured)")
        return row

    main_row = measure(code, batches[0])  # the main path: TM8192, the TPU kernel B1's shape
    c = T.get_code("TM1536")  # an M <= 256 code: the shape of the TPU kernel B2
    measure(c, np.random.default_rng(1).integers(0, 256, (B, c.k // 8), dtype=np.uint8))

    bf_max_err = 0.0

    def measure_bf(label, c, hard, mi):
        """Bit-flip kernel and its plain version in turns on (B, n) hard bits
        of code c; returns the numbers of one row."""
        nonlocal bf_max_err
        s = qc_structure(c)
        plain = lambda: bitflip_plain(s, hard, mi)  # noqa: E731
        kern = lambda: cuda_bf.bitflip(c, hard, mi)  # noqa: E731
        plain_a, want = time_ms(plain, 2)
        kern_a, got = time_ms(kern, 10)
        kern_b, _ = time_ms(kern, 10)
        plain_b, _ = time_ms(plain, 2)
        err = max_diff(got, want)
        bf_max_err = max(bf_max_err, err)
        if err != 0:
            fail(f"{label}: bit-flip kernel differs from its plain version")
        per_cw = torch.where(got.success, got.iterations + 1, got.iterations)
        sweeps = int(per_cw.sum())
        p = c.params
        nb = hard.shape[0]
        io_bytes = nb * p.n + nb * p.n_vars + 5 * nb
        E, V = p.paritycheck_sum, p.n_vars
        ops = sweeps * (BF_OPS_PER_EDGE_ITER * E + BF_OPS_PER_VAR_ITER * V)
        if p.punctured_bits and mi > 0:
            ops += nb * BF_OPS_ERASURE_PER_EDGE * E
        bytes_ms, ops_ms = io_bytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
        row = dict(
            ms=min(kern_a, kern_b), plain_ms=min(plain_a, plain_b),
            bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        )
        n_ok = int(got.success.sum())
        print(f"  {label}: kernel {kern_a:.4f} / {kern_b:.4f} ms per decode -> "
              f"{nb / row['ms'] * 1e3:.1f} cw/s; plain {plain_a:.4f} / {plain_b:.4f} ms")
        print(f"  {label}: converged {n_ok}/{nb}; sweeps {sweeps} (mean {sweeps / nb:.3f}, "
              f"max {int(per_cw.max())} per codeword); "
              f"in/out bytes {io_bytes}; int ops {ops}; bound {row['bound_ms']:.4f} ms "
              f"(bytes {bytes_ms:.4f} ms, operations {ops_ms:.4f} ms at {F32_OPS_PER_S:.3g}/s)")
        return row

    def flipped_bits(c, data_np):
        """The decode_bf protocol (benches/decode.rs:22-37): 3 flips in byte 0."""
        cw = T.encode(c, torch.from_numpy(data_np).to(dev))
        cw[:, 0] ^= FLIPS
        return T.unpack_bits(cw)

    # TM8192 (the TPU kernel B5's shape) on phase 5's first batch, then on a
    # BSC batch; TM1536 (an M <= 256 code, the shape of B6) as its layered row
    bf_row = measure_bf("TM8192 bit-flip, 3 flips", code, flipped_bits(code, batches[0]), maxiters)
    g = torch.Generator(device=dev).manual_seed(0)
    cw_bits = T.unpack_bits(T.encode(code, torch.from_numpy(batches[1]).to(dev)))
    bsc = cw_bits ^ (torch.rand(cw_bits.shape, generator=g, device=dev) < 0.006).to(torch.uint8)
    measure_bf("TM8192 bit-flip, BSC p=0.006", code, bsc, maxiters)
    c = T.get_code("TM1536")
    measure_bf("TM1536 bit-flip, 3 flips", c, flipped_bits(
        c, np.random.default_rng(1).integers(0, 256, (B, c.k // 8), dtype=np.uint8)), maxiters)
    print("  no single PyTorch call computes either decode: library_ms is null")

    # ---- 8. bit-flip kernel vs plain version ------------------------------------
    phase("8 bit-flip kernel vs plain version on the card")
    print("  tolerance: exact (integer state); max|diff| must be 0")

    def hard_batch(c, batch, seed, corrupt=True):
        """(batch, n) hard bits on the card: 1-6 random flips per codeword,
        a tenth of the bits flipped in every other one; or clean."""
        rng = np.random.default_rng(seed)
        rx = T.encode_bits(c, rng.integers(0, 2, (batch, c.k), dtype=np.uint8)).cpu().numpy()
        for i in range(batch if corrupt else 0):
            nf = c.n // 10 if i % 2 == 0 else rng.integers(1, 7)
            rx[i, rng.choice(c.n, size=nf, replace=False)] ^= 1
        return torch.from_numpy(rx).to(dev)

    def hold_bf(label, c, hard, mi):
        nonlocal bf_max_err
        got = cuda_bf.bitflip(c, hard, mi)
        torch.cuda.synchronize()
        want = bitflip_plain(qc_structure(c), hard, mi)
        err = max_diff(got, want)
        bf_max_err = max(bf_max_err, err)
        print(f"  {label:28s} B={hard.shape[0]:5d} converged {int(want.success.sum()):5d}  "
              f"mean iters {want.iterations.float().mean().item():6.2f}  max|diff| {err}")
        if err != 0:
            fail(f"{label}: bit-flip kernel differs from its plain version")
        return got

    for i, c in enumerate(T.ALL_CODES):
        got = hold_bf(f"{c} flips+heavy", c, hard_batch(c, 256, 60 + i), 20)
        if not 0 < int(got.success.sum()) < 256:
            fail(f"{c}: want a batch where some frames fail and some converge")
    for name in ("TM8192", "TC128"):
        c = T.get_code(name)
        got = hold_bf(f"{name} clean", c, hard_batch(c, 64, 5, corrupt=False), 20)
        if not bool(got.success.all()) or int(got.iterations.max()) != 0:
            fail(f"{name}: clean codewords must converge at iteration 0")
    for name in ("TM1280", "TM8192"):
        c = T.get_code(name)
        for mi in (0, 1):
            got = hold_bf(f"{name} maxiters={mi}", c, hard_batch(c, 64, 9), mi)
            if mi == 0 and bool(got.bits[:, c.n :].any()):
                fail(f"{name}: at maxiters=0 the punctured tail must stay 0")
    for name, nb in (("TM2048", 257), ("TC256", 257), ("TM6144", 1)):
        c = T.get_code(name)
        hold_bf(f"{name} B={nb}", c, hard_batch(c, nb, 13), 20)
    c = T.get_code("TM1536")
    hard = hard_batch(c, 64, 11)
    on_card = cuda_bf.bitflip(c, hard, 20)
    on_cpu = bitflip_plain(qc_structure(c), hard.cpu(), 20)
    if not all(torch.equal(a.cpu(), b) for a, b in zip(on_card, on_cpu)):
        fail("bit-flip kernel on the card differs from the plain version on the CPU")
    print("  TM1536 kernel on the card == plain version on the CPU")

    # ---- 9. the hard-decision slice's path -----------------------------------------
    phase("9 slice path: waterfall(device='cuda'), TM8192, batch 8192, one batch per point")

    def stored_frame_errors(fname, x, batch):
        with open(ROOT / "benchmarks" / "results" / fname) as f:
            for row in csv.reader(f):
                if row and not row[0].startswith("#") and row[0] == "TM8192" and float(row[1]) == x:
                    return int(row[6]) / int(row[2]) * batch
        fail(f"{fname} has no TM8192 row at {x}")

    torch.cuda.synchronize()
    cuda_bf.launches = 0
    cuda_layered.launches = 0
    points = []
    for decoder, model, x, mi, fname in WATERFALL_POINTS:
        (pt,) = T.waterfall(code, [x], batch=8192, maxiters=mi, max_bits=1,
                            max_bit_errors=10**9, noise_model=model, decoder=decoder, seed=0)
        points.append((decoder, model, mi, fname, pt))
    slice_launches = dict(bitflip_u8=cuda_bf.launches, layered_minsum_f32=cuda_layered.launches)
    for decoder, model, mi, fname, pt in points:
        want = stored_frame_errors(fname, pt.snr_db, pt.trials)
        print(f"  {decoder:2s} {model:5s} maxiters={mi:3d}: {pt.csv()}  frame errors "
              f"{pt.frame_errors} vs stored {want:.0f} ({fname}); decode failures "
              f"{pt.decode_failures}; mean iterations {pt.iterations / pt.trials:.2f}; "
              f"{pt.trials / pt.elapsed_s:.1f} cw/s end to end (host clock, data made on the card)")
        if pt.trials != 8192 or not want / BAND <= pt.frame_errors <= want * BAND:
            fail(f"{decoder} {model} {pt.snr_db}: {pt.frame_errors} frame errors, outside a "
                 f"factor {BAND} of the stored {want:.0f}")
    print(f"  launches on the slice's path: {slice_launches}")
    if min(slice_launches.values()) < 1:
        fail("the waterfall did not launch both CUDA kernels")

    # where one batch's time goes: the trial step's stages, CUDA events
    stages = ("draw", "encode", "channel", "decode", "count")
    for label, step, param in (
        ("bf bsc 0.006", make_bf_trial_step(code, 8192, 50, "bsc"), 0.006),
        ("ms ebn0 1.0 dB", make_trial_step(code, 8192, 100),
         T.noise_sigma(1.0, code, "ebn0")),
    ):
        g = torch.Generator(device=dev).manual_seed(1)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(stages) + 1)]
        torch.cuda.synchronize()
        ev[0].record()
        data, noise = step.draw(g, param)
        ev[1].record()
        cw_bits = T.encode_bits(code, data)
        ev[2].record()
        x = step.channel(cw_bits, noise, param)
        ev[3].record()
        res = step.decoder(x)
        ev[4].record()
        _count_stats(8192, code.k, data, res).frame_errors.item()
        ev[5].record()
        torch.cuda.synchronize()
        ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(len(stages))]
        print(f"  one batch of {label} (CUDA events): " + ", ".join(
            f"{name} {t:.3f} ms" for name, t in zip(stages, ms)) + f"; total {sum(ms):.3f} ms")
    print(f"  {smi}")

    print(json.dumps({"kernels": [
        {
            "name": "layered_minsum_f32",
            "route": "cuda",
            "source": "labrador_ldpc_tpu_torch/csrc/layered_minsum.cu",
            "replaces": "labrador_ldpc_tpu/ops/pallas_qc.py:728",
            "also_replaces": "labrador_ldpc_tpu/ops/pallas_tc.py:268",
            "launches": main_launches,
            "max_abs_err": max_err,
            "ms": main_row["ms"],
            "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": None,
        },
        {
            "name": "bitflip_u8",
            "route": "cuda",
            "source": "labrador_ldpc_tpu_torch/csrc/bitflip.cu",
            "replaces": "labrador_ldpc_tpu/ops/pallas_bf.py:53",
            "also_replaces": "labrador_ldpc_tpu/ops/pallas_tc.py:741",
            "launches": slice_launches["bitflip_u8"],
            "max_abs_err": bf_max_err,
            "ms": bf_row["ms"],
            "plain_ms": bf_row["plain_ms"],
            "bound_ms": bf_row["bound_ms"],
            "bound_by": bf_row["bound_by"],
            "library_ms": None,
        },
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
