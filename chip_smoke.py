"""Drive the PyTorch + CUDA port's main path on one NVIDIA H100 and check it.

    python3 chip_smoke.py [--parent DIR]

Needs one CUDA card, nvcc (CUDA_HOME, PATH or /usr/local/cuda) and the
repository checkout: it imports labrador_ldpc_tpu_torch and nothing of the
JAX package, and reads the CCSDS golden parity from tests/golden_vectors.py
(plain data). Every phase is fatal on failure; nothing is caught. With
--parent DIR (a checkout of another commit, e.g. `git archive` of the parent
unpacked into a gitignored directory), phase 7 also times that checkout's
layered min-sum, sum-product, flooding min-sum and bit-flip kernels, in
turns with this one's, on the same inputs (and counts the SASS of its
bit-flip kernel an edge visit), phases 9 and 13 drive its `bf`, `cuda_qc` and `sp_layered`
points on the same draws, which must give the same frame errors (and, for
`bf`, bit errors), and phase 14 times its flooding kernel on the same rescue
batch.

  1. build every CUDA source of the port with nvcc, all at once (four);
     print ptxas's registers, stack frame and spills of every instance of the
     layered min-sum kernel (four forms x 1, 2, 4 checks a thread), of the
     sum-product kernel (checks a thread x widest row, ops/cuda_sp.py
     INSTANCES) and of the flooding min-sum kernel (four forms x the
     instances of ops/cuda_qc.py INSTANCES), and fail on any spill, or on a
     stack frame of the sum-product or flooding kernel, whose per-check
     state must stay in registers; count the SASS (cuobjdump -sass) of the
     TM8192 sum-product instance per edge visit in pass 1, pass 2 and the
     syndrome, and its MUFU instructions per phi, and of the TM8192 float32
     flooding instance per edge visit in sweep 1 and sweep 2; print ptxas's
     registers, stack frame and spills of the bit-flip kernel, fail on a
     spill or a stack frame, and count its SASS a parity window and a count
     window (its window loops, one funnel shift a window); print ptxas's
     registers, stack frame and spills of both encoder instances (square
     and deep tiles) and fail on a spill or a stack frame;
  2. print the card's name and power limit (nvidia-smi), its SMs and its
     largest SM clock;
  3. the encoder kernel (csrc/encoder.cu) on the card against the golden
     CCSDS parity of all nine codes, and against its plain version
     (encode_bits_plain, a float32 matmul) on all nine codes at B = 1, 33,
     8192 and 32768 on random bytes (bit 0 is the data bit), one launch a
     call; then its device time (torch.profiler, 20 launches) and a call's
     time back to back (CUDA events) at TM8192, B=8192 and TC512, B=32768
     beside its launch shape, its bound (the int8 tensor cores'
     2 k (n - k) operations a codeword, or the bytes), its LOP3 floor (k/32
     x (n - k) a codeword at 64 an SM a clock), the plain version's time and
     the library yardstick's: torch._int_mm in int8 on the tensor cores, & 1,
     the cast and the concatenation, held equal to the kernel and timed on
     the device (the calls queued behind a spin kernel);
  4. the layered min-sum kernel (float32) against its plain PyTorch version
     on the card, all nine codes, noisy LLRs where some frames fail (B=256,
     maxiters=20), alpha=0.8 on all nine codes, maxiters 0/1 cases and
     B=257 and B=1: identical bits, success and iterations;
  5. the main path: 8 serving batches of TM8192, B=16384, 3 flipped bits in
     byte 0, maxiters=50, through encode -> hard_to_llrs -> decode_ms
     (impl="auto"), every frame's data verified, one launch of the float32
     form per batch, and the peak device memory over the 8 batches
     (max_memory_allocated after reset_peak_memory_stats); then one int8
     serving batch (the same LLRs through quantize_llrs) and one bfloat16
     serving batch (the same LLRs cast) through decode_ms(impl="auto"), the
     int8 and bf16 forms of the layered kernel, each exactly one launch;
     launch counts are reset just before and read just after each;
  6. TM8192 at 1.0 dB, B=256, maxiters=50 (deep iterations and failures):
     kernel against plain version, bit for bit;
  7. the layered kernel's launch shape for every code and form (threads,
     checks a thread, shared bytes, CTAs per SM as the card's occupancy
     calculator reports them, which must equal the count at ptxas's
     registers and be no fewer than launch_config's at 64; the syndrome's
     check words and windows a sweep); then
     times (CUDA events) of each kernel form and of its plain version at
     its path's shapes, and each one's bound: the layered kernel (float32,
     int8, int16, bf16) and the flooding kernel (float32, bf16, int8, int16)
     at TM8192,
     B=16384, maxiters=50 on the 3-flip batch of phase 5, the flooding
     float32 form also at Eb/N0 1.1 dB, the layered float32 form also at
     1.5 dB (TM8192, B=16384, and TC512, B=32768), every form at TM1536
     (each layered time with its launch shape and its syndrome's check words
     and windows a sweep, each flooding time with its launch shape and
     barriers per iteration, and, with --parent, the parent's kernel of
     either kind in turns; at TM8192 the flooding kernel's issue floor of
     the SASS count), the
     bit-flip kernel at TM8192, B=16384, maxiters=50 on the 3-flip batch
     (the decode_bf protocol, benches/decode.rs:22-37), on a BSC(p=0.006)
     batch where failing frames run deep, and at TM1536 on 3 flips, each
     with its launch shape (the card's CTAs per SM must equal
     launch_config's at ptxas's registers), its bound (bytes, or the
     parent design's operations over 32 bits an operation) and its SASS
     issue floor; the
     layered sum-product kernel at TM8192, Eb/N0 0.9 dB, B=8192, maxiters
     100 (true LLRs 2y/sigma^2), and at TM1536, Eb/N0 2.0 dB, each with its
     launch shape (the card's CTAs per SM must equal launch_config's) and
     barriers per iteration, at TM8192 with the issue floor of its SASS
     count (instructions an edge visit x edge visits / 32 at four warp
     instructions an SM a clock) and its MUFU floor;
  8. the bit-flip kernel against its plain PyTorch version on the card, all
     nine codes (B=256, 1-6 flips plus heavy corruption on half the batch,
     maxiters=20), clean codewords, maxiters 0 and 1, odd batch sizes, a
     batch whose hard bits start one byte into their buffer, and once
     against the plain version on the CPU: identical bits, success and
     iterations; and its launch shape for every code, the card's CTAs per SM
     held to launch_config's;
  9. the slices' waterfall paths: `waterfall(..., device="cuda")` at
     TM8192, batch 8192, one batch per point: bit-flip over Eb/N0 6.5 dB,
     BSC 0.006 and BEC 0.012, soft min-sum at 1.0 dB, and the quantized-LLR
     points at Eb/N0 1.1 dB, maxiters 100 (layered "auto" in int8 and
     int16, flooding "cuda_qc" in int8, int16 and float32; bf16 "auto" and
     "cuda_qc", each beside the card's float32 count on the same draws);
     each point's frame errors (bit errors against the stored layered f32
     curve) within a factor 2 of the stored curve or anchor
     (benchmarks/results); launch counts are reset just before and read
     just after each point, and each batch of the first four points must
     take one launch of the encoder kernel; then the stage times (CUDA
     events) of one bit-flip, one float32 and one int8 min-sum batch;
 10. the int8/int16/bf16 forms of the layered kernel against their plain
     version on the card, all nine codes: batches where some frames fail and
     some converge, with full-range random LLRs in each int batch, clean
     batches, maxiters 0 and 1, B=257 and B=1, and once against the plain
     version on the CPU; bf16 also with alpha=0.8;
 11. the same for the flooding kernel in float32 and bf16 (each also with
     alpha=0.8), int8 and int16; and its launch shape for every code and
     form, with the card's CTAs per SM held to launch_config's at ptxas's
     registers;
 12. the layered sum-product kernel against its plain version on the card,
     all nine codes (B=256, maxiters 20, true LLRs where some frames fail and
     some converge), clean batches, maxiters 0 and 1, B=257 and B=1: identical
     bits, success and iterations; its launch shape per code, with the
     card's CTAs per SM held to launch_config's; and once
     against the plain version on the CPU, within the CPU tests' tolerance
     (tests/test_torch_sumproduct.py: PyTorch's CPU exp/log are not the
     card's);
 13. the sum-product slice's waterfall points, `waterfall(..., device="cuda",
     noise_model="ebn0")`, batch 8192, maxiters 100, one batch each:
     impl="sp_layered" (the kernel) at TM8192 0.9 dB and impl="sp" (flooding
     BP, plain PyTorch on the card) at TM2048 1.3 dB, each within a factor 2
     of its stored anchor, with the launch counters reset around each point;
     then the stage times of one sp_layered batch;
 14. the two-stage decoder, make_two_stage_decoder with its defaults (bf16
     layered kernel, 25 iterations; float32 flooding kernel, 100, on the
     failed frames only) on a TM8192 batch of 8192 at Eb/N0 1.1 dB: equal
     to the two stages composed by hand on the card, one launch of the bf16
     layered form and one of the f32 flooding form only if a frame failed,
     and every converged frame's data bits those sent;
 15. the launch table: for every code, kernel and dtype form,
     the CTAs per SM of the route's shape (ops/routing.route_for) by the one
     occupancy rule (ops/card.ctas_per_sm), and those sizes.decoder_memory
     reports, at ptxas's registers (phase 1) equal the card's occupancy
     calculator (each wrapper's card_ctas_per_sm); then
     the memory table of `python -m labrador_ldpc_tpu_torch sizes`;
 16. serving (serve.py): 16 batches of TM8192, B=16384, 3 flips, 4 in
     flight, every frame checked (converged, data bytes those sent), the
     sustained frames/s and the pipelined slope's ms a decode dispatch; the
     layered_minsum_f32 launches must equal the loop's dispatches (warm-up,
     batches and the slope's);
 17. data parallelism on the card, TM8192, global batch 8192, one batch,
     seed 0: the waterfall at Eb/N0 1.0 dB (impl="auto") on (a) one rank
     of an NCCL process group and (b) two ranks spawned from this script
     (`--rank`) sharing the card over Gloo, and (c) on those two ranks the
     bit-flip point at BSC 0.006 and make_sharded_decoder on phase 5's first
     batch (B=16384): counters equal to the unsharded run's, the sharded
     decode equal to the unsharded one (a sha256 of bits, success and
     iterations); each rank reports its own kernel launches, and a rank that
     launched nothing fails the run, and its `parallel.mesh.collective_calls`,
     which must count one `all_reduce` a batch drained (of 5 int32 counters
     on the NCCL rank). On the NCCL rank and on both Gloo
     ranks: (d) the 1.0 dB point for three batches, plain and checkpointed
     (rank 0 alone writes the file), then cut by rank 0 to the config and the
     first point line and resumed after a barrier: the counters of all three
     equal the unsharded run's and the point lines are one writer's, with
     the walls of the plain and the checkpointed point, the ms of the
     resumed open's own broadcast and the mean of 20 warm ones; (e) the sum-product kernel (TM8192 true LLRs at
     Eb/N0 0.9 dB, 8192 frames, maxiters 100), (f) the bit-flip kernel
     (TM8192 BSC 0.006, 8192 frames, make_sharded_bf_decoder) and (g) the
     int8 layered and bf16 flooding forms on phase 5's first batch, each
     split over the ranks: the sha256 equal to the unsharded decode's, and
     each form launched on each rank;
 18. the measurement entry points, with the launch counters reset before and
     after (their launches are not in the kernels line): (a) `bench.measure`
     (TM8192, B=16384, 3 flips, maxiters 50, cuda_layered f32, trains of up
     to 32 decodes), its JSON line and its fit (R^2, points, residuals);
     (b) `bench_suite --codes TC128,TM8192 --impls
     cuda_layered:float32,cuda_qc:int8 --pipeline 8 --reps 1 --strict`,
     which must exit 0 with every kernel row held to its plain version and
     recorded; (c) `profile_decode` of the serving decode (cuda_layered f32,
     B=16384, 3 decodes): the top ten device operations, the device busy
     share and the longest idle gaps, or the line saying that torch.profiler
     saw no device time;
 19. the quality tools (labrador_ldpc_tpu_torch/tools/), into a temporary
     directory, with the launch counters reset before and after (their
     launches are printed on a line of their own): the TM8192 1.1 dB and
     TC512 1.0 dB (perftest) f32 anchors and the TM8192 sum-product anchor at
     their full budgets (gen_ber_anchors), one cross_db walk (TC128 ms) and
     one cross_p walk (TC128 bf); tools.compare holds every row and the two
     crossings to the TPU's tables (benchmarks/results) by its fixed
     statistic, and any failed pair fails the run.
Then one JSON line `{"kernels": [...]}` (eleven kernel forms, the encoder
last); the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import csv
import importlib
import importlib.util
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s and float32
# operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# int8 operations/s of the tensor cores, dense: the encoder's bound counts
# its 0/1 product there (portbench/roofline.py, `encoder`)
INT8_TC_OPS_PER_S = 1979e12
# the integer pipe's 32-bit logic operations an SM a clock (64 lanes): the
# encoder kernel's LOP3 floor
INT_LANES_PER_SM = 64
# float32 operations per edge and iteration in csrc/layered_minsum.cu:
# 12 in pass 1 (sub, 3 compares, select, abs, compare, 2 mins, select,
# sign compare and xor counted as one), 7 in pass 2 (abs, compare, select,
# sign compare, negate-select, sub, add), 1 in the syndrome; alpha adds 1
OPS_PER_EDGE_ITER = 20
# integer operations of the parent design of csrc/bitflip.cu (one byte a
# bit), counted from its source: per edge and iteration 5 in the parity sweep
# (kind test, add, mask of a rotation's perm_index; address; xor) and 5 in
# the count sweep (the same for perm_inverse; add); per variable and
# iteration 3 (max, compare, xor); the erasure pass costs one parity sweep.
# The bit-packed kernel does this work 32 edges or variables a 32-bit
# operation, so its operations are these counts over BF_BITS_PER_OP (the
# bound counts that); the counts themselves are printed as the parent
# design's operations. The data-sheet peaks above give no integer rate: the
# operations are divided by the float32 rate outside the tensor cores
# (F32_OPS_PER_S), the SM's widest non-tensor pipe, so the bound is a lower
# bound.
# integer operations per edge and iteration of the int8/int16 forms of
# csrc/layered_minsum.cu: the float32 count plus the clamp of t (2) and the
# saturating abs (1)
OPS_PER_EDGE_ITER_SAT = 23
# operations per edge and iteration in csrc/flooding_minsum.cu, counted from
# the source: sweep 1 (perm_inverse 4, the message u 6, add 1) and sweep 2
# (perm_index 3, u 6, sub 1, self-correction 4, parity 2, abs 1, two-min 4,
# sign 2); the int forms add two clamps (2 each) and the saturating abs (1)
FLOOD_OPS_PER_EDGE_ITER = 34
FLOOD_OPS_PER_EDGE_ITER_SAT = 39
# the bf16 forms count the float32 operations plus each conversion between
# bfloat16 and float32 as one: layered 6 loads/stores of u, t' and 6 in the
# roundings of |t| and of the posterior update (bf16(va + bf16(d))); flooding
# 5 loads/stores of v, m1, m2, g and 7 in the roundings of u, the posterior
# and |nv|. The flooding counts are those of the kernel the redesign of
# csrc/flooding_minsum.cu replaced, kept so that its bound stays comparable;
# phase 1 counts the SASS of the redesign itself
OPS_PER_EDGE_ITER_BF16 = 32
FLOOD_OPS_PER_EDGE_ITER_BF16 = 46
BF_OPS_PER_EDGE_ITER = 10
BF_OPS_PER_VAR_ITER = 3
BF_OPS_ERASURE_PER_EDGE = 5
BF_BITS_PER_OP = 32

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
# float32 operations per edge and iteration in csrc/sumproduct.cu, counted
# from the source: pass 1 (perm_index 3, sub, abs, phi 8, sign compare, sum
# add, sign xor, signed store's select), pass 2 (abs, sub, phi 8, sign bit 2,
# xor, negate-select, perm_index 3, sub, add) and the syndrome (perm_index 3,
# compare, xor). phi counts its clamp (2), negate, expf, add, sub, IEEE
# division and logf as one operation each; expf, logf and the division take
# many instructions each, so the bound is a lower bound
SP_OPS_PER_EDGE_ITER = 41
# the sum-product slice's waterfall points, Eb/N0, maxiters 100, batch 8192:
# (impl, code, dB, stored point measured with the JAX package on the TPU)
SP_WATERFALL_POINTS = (
    ("sp_layered", "TM8192", 0.9, "ber_regression_points_sp.csv"),
    ("sp", "TM2048", 1.3, "sp_ms_gap_points.csv"),
)

# the quantized-LLR slice's points: TM8192, Eb/N0 1.1 dB, maxiters 100;
# (impl, dtype, stored anchor measured on the TPU: frame errors in column 7)
INT_WATERFALL_POINTS = (
    ("auto", "int8", "ber_regression_points_i8.csv"),
    ("auto", "int16", "ber_regression_points_i16.csv"),
    ("cuda_qc", "int8", "ber_regression_points_i8_flooding.csv"),
    ("cuda_qc", "int16", "ber_regression_points_i16_flooding.csv"),
    ("cuda_qc", "float32", "ber_regression_points.csv"),
)
# the bf16 slice's points: TM8192, Eb/N0 1.1 dB, maxiters 100, batch 8192;
# no bf16 anchor is stored, so each is held to the stored float32 record of
# its schedule: (impl, kernel form, file, column of the count, count name)
BF16_WATERFALL_POINTS = (
    ("auto", "layered_minsum_bf16", "waterfall_tm8192_ebn0_pallas_layered_f32.csv", 4,
     "bit_errors"),
    ("cuda_qc", "flooding_minsum_bf16", "ber_regression_points.csv", 7, "frame_errors"),
)
BAND = 2.0  # observed/stored frame errors in [1/BAND, BAND] (tests/test_ber_regression.py)


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def instance_name(kernel: str, args: str) -> str:
    """A kernel template's instance from the mangled template arguments:
    "kernel<form, checks>" or "kernel<checks, widest row>"."""
    types = {"f": "f32", "13__nv_bfloat16": "bf16", "a": "i8", "s": "i16"}
    form = re.sub(r"Li\d+E", "", args)
    parts = ([types.get(form, form)] if form else []) + re.findall(r"Li(\d+)E", args)
    return f"{kernel}<{', '.join(parts)}>"


def ptxas_functions(log: str, kernel: str) -> dict[str, tuple[str, str]]:
    """The register and stack/spill lines that `nvcc -Xptxas -v` printed for
    each instance of a kernel template, by instance (`instance_name`)."""
    out, name, spill = {}, None, ""
    for line in log.splitlines():
        m = re.search(rf"Function properties for \S*{kernel}I(\w+?)EEv", line)
        if m:
            name, spill = instance_name(kernel, m.group(1)), ""
        elif name and "spill" in line:
            spill = line.strip()
        elif name and "registers" in line:
            out[name] = (line.split(":", 1)[-1].strip(), spill)
            name = None
    return out


def sass_lines(so: Path, function: str) -> list[tuple[int, str, str]]:
    """(address, opcode, instruction text), in order, of the function of a
    built library whose mangled name contains `function`, from `cuobjdump
    -sass`."""
    from labrador_ldpc_tpu_torch.ops import _nvcc

    tool = Path(_nvcc._nvcc()).with_name("cuobjdump")
    dump = subprocess.run([str(tool), "-sass", str(so)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    out, inside = [], False
    for line in dump.splitlines():
        if "Function :" in line:
            inside = function in line
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line) if inside else None
        if m:
            toks = [t for t in m.group(2).split() if not t.startswith("@")]
            out.append((int(m.group(1), 16), toks[0] if toks else "", m.group(2)))
    return out


def sass_ops(so: Path, function: str) -> list[str]:
    """The opcodes, in order, of the function of a built library whose
    mangled name contains `function`, from `cuobjdump -sass`."""
    return [op for _, op, _ in sass_lines(so, function)]


def sass_loops(lines: list[tuple[int, str, str]], marker: str) -> list[tuple[int, list[str]]]:
    """The innermost loops of a function's SASS (`sass_lines`) whose body
    holds an instruction whose opcode starts with `marker`: (first address,
    the body's opcodes from the branch target to the backward branch), in
    address order. A loop is a BRA to a lower address; innermost means no
    other such loop lies inside it."""
    spans = []
    for addr, op, text in lines:
        m = re.search(r"0x([0-9a-f]+)", text) if op.startswith("BRA") else None
        if m and int(m.group(1), 16) < addr:
            spans.append((int(m.group(1), 16), addr))
    spans = [s for s in spans if not any(o != s and s[0] <= o[0] and o[1] <= s[1] for o in spans)]
    out = []
    for lo, hi in sorted(set(spans)):
        body = [op for addr, op, _ in lines if lo <= addr <= hi]
        if any(op.startswith(marker) for op in body):
            out.append((lo, body))
    return out


def bf_sass_counts(so: Path) -> dict | None:
    """Static SASS instructions a window of csrc/bitflip.cu: its window loops
    (one funnel shift, SHF.R.W, a window) are, in address order, the erasure
    vote's parity loop and tail loop, the parity loop and the count loop
    (`#pragma unroll 1`); a loop's body, its loop overhead and the
    carry-save add included, is one window. None (with the reason printed)
    if the SASS is not so."""
    lines = sass_lines(so, "bitflip_kernel")
    loops = [(lo, len(body), sum(op.startswith("SHF.R.W") for op in body))
             for lo, body in sass_loops(lines, "SHF.R.W")]
    if len(loops) != 4 or any(marks != 1 for _, _, marks in loops):
        print(f"  SASS of bitflip_kernel: {len(lines)} instructions; funnel-shift loops (address, "
              f"instructions, funnel shifts) {loops}: not the expected four of one; no count")
        return None
    out = {"parity": loops[2][1], "count": loops[3][1]}
    print(f"  SASS of bitflip_kernel: {len(lines)} instructions; a parity window {out['parity']}, "
          f"a count window {out['count']} instructions (loop bodies at {loops[2][0]:#x} and "
          f"{loops[3][0]:#x}; the vote's parity and tail loops {loops[0][1]} and {loops[1][1]})")
    return out


def parent_bf_sass_counts(so: Path) -> float | None:
    """Static SASS instructions an edge visit of the parent design of
    csrc/bitflip.cu (one byte a bit): over the innermost loops whose body
    reads both the addend table in device memory (LDG) and a byte of shared
    memory (LDS.U8, one an edge visit), the body's instructions over its byte
    loads, both arms of the rotation/pi branch counted; the mean over those
    loops (the vote's, the parity sweep's and the count sweep's, unrolled or
    not)."""
    lines = sass_lines(so, "bitflip_kernel")
    loops = [len(body) / sum(op.startswith("LDS.U8") for op in body)
             for _, body in sass_loops(lines, "LDS.U8") if any(op.startswith("LDG") for op in body)]
    if not loops:
        print(f"  SASS of the parent's bitflip_kernel: {len(lines)} instructions; no loop reads "
              f"the table and a shared byte; no count")
        return None
    mean = sum(loops) / len(loops)
    print(f"  SASS of the parent's bitflip_kernel: {len(lines)} instructions; instructions an "
          f"edge visit of its {len(loops)} table-reading loops {[round(x, 2) for x in loops]}, "
          f"mean {mean:.2f}")
    return mean


def sass_counts(so: Path, kernel: str, K: int, width: int) -> dict | None:
    """Static SASS instruction counts of one instance of the sum-product
    kernel (K checks a thread, rows of `width` addends), from `cuobjdump
    -sass` of the built library, cut at its barriers: pass 1 runs from the
    initialisation's BAR.SYNC to the next, pass 2 from there to the last
    BAR.SYNC before the syndrome's BAR.RED, the syndrome from there to
    BAR.RED. Both passes and the syndrome's row are unrolled over j < width,
    so a region's count over K*width is its instructions per edge visit of a
    full row, its loop overhead included, counting both arms of every branch
    (the rotation's and the pi permutation's index, the division's rarely
    taken slow-path call), so an upper estimate of what a visit issues; pass
    1's MUFU instructions over K*width are those of one phi. None (with the
    reason printed) if the SASS is not cut so."""
    ops = sass_ops(so, f"{kernel}ILi{K}ELi{width}EEEv")
    label = f"{kernel}<{K}, {width}>"
    syncs = [i for i, op in enumerate(ops) if op.startswith("BAR") and ".RED" not in op]
    reds = [i for i, op in enumerate(ops) if op.startswith("BAR.RED")]
    if len(syncs) != width + 2 or len(reds) != 1 or syncs[-1] > reds[0]:
        print(f"  SASS of {label}: {len(ops)} instructions, BAR.SYNC at {syncs}, BAR.RED at "
              f"{reds}: not the expected {width + 2} BAR.SYNC before one BAR.RED; no count")
        return None
    visits = K * width
    cuts = {"pass 1": (syncs[0], syncs[1]), "pass 2": (syncs[1], syncs[-1]),
            "syndrome": (syncs[-1], reds[0])}
    out = {name: (b - a - 1) / visits for name, (a, b) in cuts.items()}
    mufu: dict[str, int] = {}
    for op in ops[syncs[0] + 1 : syncs[1]]:
        if op.startswith("MUFU"):
            mufu[op] = mufu.get(op, 0) + 1
    out["mufu_per_phi"] = {op: n / visits for op, n in sorted(mufu.items())}
    print(f"  SASS of {label}: {len(ops)} instructions ({len(ops) - reds[0] - 1} after the "
          f"syndrome's BAR.RED: the output loop and the division's slow path); per edge visit "
          f"of a {width}-addend row: pass 1 {out['pass 1']:.2f}, pass 2 {out['pass 2']:.2f}, "
          f"syndrome {out['syndrome']:.2f} instructions; MUFU per phi {out['mufu_per_phi']}")
    return out


def flood_sass_counts(so: Path, K: int, R: int, width: int) -> dict | None:
    """Static SASS instruction counts of the float32 instance of the flooding
    kernel with K checks a thread, R block rows and rows of `width` addends,
    from `cuobjdump -sass` of the built library, cut at its barriers: sweep
    1 runs from the staging's BAR.SYNC to the run loop's BAR.SYNC, sweep 2
    from there to the BAR.RED of __syncthreads_or. Each region's count over
    its edge-visit copies (sweep 1: its stores to va, one a visit, every
    row's and the alpha arm's copy counted; sweep 2: its 16-bit loads of an
    edge's variable index, one a visit of one row's unrolled body) is its
    instructions per edge visit, the run-word shuffle and loop overhead
    spread over the copies and both arms of every branch counted, so an
    estimate of what a visit issues.
    None (with the reason printed) if the SASS is not cut so."""
    ops = sass_ops(so, f"flooding_minsum_kernelIfLi{K}ELi{R}ELi{width}EEEv")
    label = f"flooding_minsum_kernel<f32, {K}, {R}, {width}>"
    syncs = [i for i, op in enumerate(ops) if op.startswith("BAR") and ".RED" not in op]
    reds = [i for i, op in enumerate(ops) if op.startswith("BAR.RED")]
    if len(syncs) != 2 or len(reds) != 1 or syncs[-1] > reds[0]:
        print(f"  SASS of {label}: {len(ops)} instructions, BAR.SYNC at {syncs}, BAR.RED at "
              f"{reds}: not the expected 2 BAR.SYNC before one BAR.RED; no count")
        return None
    s1, s2 = ops[syncs[0] + 1 : syncs[1]], ops[syncs[1] + 1 : reds[0]]
    copies1 = sum(op.startswith("STS") for op in s1)
    copies2 = sum(op.startswith("LDS.U16") for op in s2)
    if copies1 == 0 or copies2 != K * width:
        print(f"  SASS of {label}: {copies1} stores in sweep 1, {copies2} index loads in "
              f"sweep 2 (want {K * width}); no count")
        return None
    out = {"sweep 1": len(s1) / copies1, "sweep 2": len(s2) / copies2}
    print(f"  SASS of {label}: {len(ops)} instructions; sweep 1 {len(s1)} over {copies1} "
          f"visit copies, {out['sweep 1']:.2f} an edge visit; sweep 2 {len(s2)} over {copies2}, "
          f"{out['sweep 2']:.2f} an edge visit")
    return out


def phase(name: str):
    print(f"== {name}", flush=True)


def load_parent(root: Path):
    """The port package of another checkout (the parent commit), imported as
    `parent_port` beside this one; it builds its kernels from its own
    sources, into its own checkout."""
    pkg = root.resolve() / "labrador_ldpc_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        "parent_port", pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["parent_port"] = mod
    spec.loader.exec_module(mod)
    for name in ("cuda_layered", "cuda_sp", "cuda_qc", "cuda_bf", "_nvcc"):
        importlib.import_module(f"parent_port.ops.{name}")
    return mod


# phase 17's waterfall points: TM8192, global batch 8192, one batch, seed 0
P17_MS = dict(code="TM8192", snrs_db=[1.0], batch=8192, max_bits=1, noise_model="ebn0",
              seed=0, impl="auto")
P17_BF = dict(code="TM8192", snrs_db=[0.006], batch=8192, max_bits=1, noise_model="bsc",
              seed=0, decoder="bf")
P17_FIELDS = ("trials", "bits", "bit_errors", "frame_errors", "decode_failures", "iterations")
# (d): the min-sum point for three batches of 8192 (k = 4096), checkpointed
P17_CKPT = dict(P17_MS, max_bits=3 * 8192 * 4096, max_bit_errors=10**9)
# (e)-(g): the decodes split over the ranks, each held to its unsharded
# sha256: (case, kernel form launched, label)
P17_SPLIT = (
    ("sp", "sumproduct_f32", "(e) TM8192 true LLRs at 0.9 dB, 8192 frames, cuda_sp, maxiters 100"),
    ("bf", "bitflip_u8", "(f) TM8192 BSC 0.006, 8192 frames, make_sharded_bf_decoder, maxiters 50"),
    ("i8", "layered_minsum_i8", "(g) phase 5's first batch in int8, cuda_layered, maxiters 50"),
    ("bf16", "flooding_minsum_bf16", "(g) phase 5's first batch in bf16, cuda_qc, maxiters 50"),
)


def result_digest(res) -> str:
    """sha256 of a decode result's success flags, iterations and bits."""
    import hashlib

    h = hashlib.sha256()
    for t in (res.success, res.iterations, res.bits):
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()


def serving_llrs(T, dev):
    """Phase 5's first TM8192 serving batch (B=16384, 3 flips) as LLRs."""
    import torch

    from labrador_ldpc_tpu_torch.serve import flipped_codewords

    return T.hard_to_llrs(flipped_codewords("TM8192", 16384, dev)[1], torch.float32, dev)


def allreduce_ms(mesh, reps: int = 20) -> float:
    """Host-clock ms of one all_reduce of the five (5,) int32 counters."""
    import torch

    from labrador_ldpc_tpu_torch.parallel.mesh import all_reduce_sum

    x = torch.zeros(5, dtype=torch.int32, device=mesh.device)
    all_reduce_sum(mesh, x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        all_reduce_sum(mesh, x)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def p17_inputs(T, dev) -> dict:
    """Phase 17 (e)-(g)'s inputs, the same in every process on the card (one
    seeded card generator): TM8192 true LLRs 2y/sigma^2 at Eb/N0 0.9 dB and
    TM8192 hard bits through BSC 0.006, 8192 frames each; phase 5's first
    serving batch quantized to int8 and cast to bf16."""
    import torch

    from labrador_ldpc_tpu_torch.channel.awgn import _awgn_true_llrs

    code = T.get_code("TM8192")
    gen = torch.Generator(device=dev).manual_seed(17)

    def codewords():
        data = torch.randint(0, 2, (8192, code.k), generator=gen, device=dev, dtype=torch.uint8)
        return T.encode_bits(code, data, dev)

    cw = codewords()
    sp = _awgn_true_llrs(cw, torch.randn(cw.shape, generator=gen, device=dev),
                         T.noise_sigma(0.9, code, "ebn0"))
    cw = codewords()
    bf = cw ^ (torch.rand(cw.shape, generator=gen, device=dev) < 0.006).to(torch.uint8)
    llrs = serving_llrs(T, dev)
    return {"sp": sp, "bf": bf, "i8": T.quantize_llrs(llrs, torch.int8),
            "bf16": llrs.to(torch.bfloat16)}


def p17_decoders(T, mesh=None) -> dict:
    """Phase 17 (e)-(g)'s decoders, split over `mesh`'s ranks, or unsharded
    on the card without a mesh."""
    import torch

    from labrador_ldpc_tpu_torch.parallel import make_sharded_bf_decoder, make_sharded_decoder

    if mesh is None:
        return {
            "sp": T.make_sp_decoder_cuda("TM8192", 100),
            "bf": T.make_bf_decoder_cuda("TM8192", 50),
            "i8": lambda x: T.decode_ms("TM8192", x, maxiters=50, impl="cuda_layered"),
            "bf16": lambda x: T.decode_ms("TM8192", x, maxiters=50, impl="cuda_qc"),
        }
    return {
        "sp": make_sharded_decoder("TM8192", mesh, torch.float32, 100, impl="cuda_sp"),
        "bf": make_sharded_bf_decoder("TM8192", mesh, 50, impl="cuda"),
        "i8": make_sharded_decoder("TM8192", mesh, torch.int8, 50, impl="cuda_layered"),
        "bf16": make_sharded_decoder("TM8192", mesh, torch.bfloat16, 50, impl="cuda_qc"),
    }


def kernel_launches(form: str) -> int:
    """Launches of a kernel form since its counter was last set to 0."""
    from labrador_ldpc_tpu_torch.ops import cuda_bf, cuda_encoder, cuda_layered, cuda_qc, cuda_sp

    single = {"sumproduct_f32": cuda_sp, "bitflip_u8": cuda_bf, "encoder_u8": cuda_encoder}
    if form in single:
        return single[form].launches
    kind, _, dtype = form.split("_")
    return (cuda_layered if kind == "layered" else cuda_qc).form_launches[dtype]


def reset_launches() -> None:
    """Set every kernel wrapper's launch counters to 0."""
    from labrador_ldpc_tpu_torch.ops import cuda_bf, cuda_encoder, cuda_layered, cuda_qc, cuda_sp

    for mod in (cuda_layered, cuda_qc, cuda_bf, cuda_sp, cuda_encoder):
        mod.launches = 0
    for mod in (cuda_layered, cuda_qc):
        for form in mod.form_launches:
            mod.form_launches[form] = 0


def quality_tools(smi: str) -> None:
    """Phase 19: the quality tools' reduced cases into a temporary directory,
    every row and both crossings held to the TPU's tables by tools.compare;
    the launch counters are set to 0 before and after."""
    from labrador_ldpc_tpu_torch.tools import Run, TPU_RESULTS, compare, write_table
    from labrador_ldpc_tpu_torch.tools import gen_ber_anchors, gen_bsc_thresholds, gen_gap_table

    reset_launches()
    t19 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        argv = ["(chip_smoke.py phase 19)"]
        # (a) two f32 anchors and the sum-product anchor at their full budgets
        run = Run(device="cuda")
        gen_ber_anchors.anchors(run, tmp, argv, grid=[("TM8192", "ebn0", [1.1]),
                                                      ("TC512", "perftest", [1.0])])
        gen_ber_anchors.main_sp(run, tmp, argv)
        # (b) one walk of each axis, TC128: ms over Eb/N0, bf over BSC p
        crossings = []
        walks = (
            (gen_gap_table, "bf_ms_gap_table.csv", "ms_db", "bf_ms_gap_points.csv",
             lambda log, run: gen_gap_table.cross_db(
                 "TC128", "ms", 1e-3, log, fer_fn=partial(gen_gap_table.fer_at, run=run))),
            (gen_bsc_thresholds, "bsc_thresholds.csv", "p_star_bf", "bsc_threshold_points.csv",
             lambda log, run: gen_bsc_thresholds.cross_p("TC128", "bf", 1e-3, log, run)),
        )
        for module, table, col, points, walk in walks:
            run = Run(device="cuda")
            log = []
            x = walk(log, run)
            header = module.POINTS_HEADER.format(table=table)
            write_table(tmp / points, header, log, run, module.__name__.rsplit(".", 1)[1], argv)
            cols, rows = compare.read_table(TPU_RESULTS / table)
            tpu = next(float(r[cols.index(col)]) for r in rows if r[0] == "TC128")
            crossings.append(compare.crossing(table, "TC128", col, x, tpu))
        pairs, files, _ = compare.compare_dirs(tmp, TPU_RESULTS)
        pairs += crossings
    for pair in pairs:
        print(f"  {pair.line()}")
    gated = [p for p in pairs if p.gated]
    failed = [p for p in gated if not p.ok]
    launched = {name: kernel_launches(name) for name in (
        "layered_minsum_f32", "flooding_minsum_f32", "bitflip_u8", "sumproduct_f32")}
    print(f"  phase 19: {len(files)} files, {len(gated)} gated pairs, {len(failed)} failed, "
          f"{len(pairs) - len(gated)} ungated; {time.perf_counter() - t19:.2f} s on {smi}")
    print(f"  phase 19: its own launches {launched} (not in the kernels line)")
    if failed or not gated:
        fail(f"phase 19: {len(failed)} of {len(gated)} gated pairs failed")
    if not all(launched.values()):
        fail(f"phase 19: a kernel of the tools' path was not launched: {launched}")
    reset_launches()


def split_cases(T, mesh) -> dict:
    """Phase 17 (e)-(g) on this rank: each decode split over the mesh, timed
    after one warm run of the same decode (the first run at a size also
    allocates its buffers and the gather's), with this rank's launches of
    its kernel form and the sha256 of the gathered result."""
    import torch

    inputs, decoders = p17_inputs(T, mesh.device), p17_decoders(T, mesh)
    out = {}
    for case, form, _ in P17_SPLIT:
        decoders[case](inputs[case])  # warm
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        res = decoders[case](inputs[case])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0  # before the digest's copy to the host
        out[case] = {"digest": result_digest(res), "launches": kernel_launches(form), "s": wall}
    return out


def checkpoint_cycle(T, mesh, path: Path) -> dict:
    """Phase 17 (d) on this rank: P17_CKPT (three batches) without and with a
    checkpoint at `path` (the same path on every rank), each timed after one
    warm run; rank 0 cuts the file to the config and the first point line,
    every rank meets at a barrier and resumes. Returns the counters of the
    three runs, their walls, this rank's launches of the layered kernel in
    the checkpointed run, the `batches` of the file's point lines (rank 0)
    before the cut and after the resume, the ms of the resumed run's own
    broadcast at open (one cold call, timed inside the open) and the mean ms
    of 20 warm broadcast_object calls of the same payload."""
    import torch
    import torch.distributed as dist

    from labrador_ldpc_tpu_torch.parallel import broadcast_object

    # the module, not the function `channel` exports under the same name
    waterfall_module = importlib.import_module("labrador_ldpc_tpu_torch.channel.waterfall")

    def run(**kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pt = T.waterfall(**P17_CKPT, device="cuda", mesh=mesh, **kw)[0]
        torch.cuda.synchronize()
        return [getattr(pt, f) for f in P17_FIELDS], time.perf_counter() - t0

    def records():
        return [json.loads(line) for line in path.read_text().splitlines()]

    def batches():
        return [r["batches"] for r in records() if r["kind"] == "point"] if mesh.rank == 0 else None

    opens = []  # (ms, payload) of each broadcast the open makes

    def timed_broadcast(m, obj):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = broadcast_object(m, obj)
        torch.cuda.synchronize()
        opens.append(((time.perf_counter() - t0) * 1e3, got))
        return got

    run()  # warm
    out = {}
    out["plain"], out["plain_s"] = run()
    reset_launches()
    out["full"], out["ckpt_s"] = run(checkpoint=path)
    out["launches"] = kernel_launches("layered_minsum_f32")
    out["batches_full"] = batches()
    if mesh.rank == 0:  # the interruption
        recs = records()
        path.write_text("".join(json.dumps(r) + "\n" for r in recs[:2]))
    dist.barrier()
    waterfall_module.broadcast_object = timed_broadcast
    try:
        out["resumed"], out["resumed_s"] = run(checkpoint=path)
    finally:
        waterfall_module.broadcast_object = broadcast_object
    out["batches_resumed"] = batches()
    if len(opens) != 1:
        fail(f"the resumed checkpointed run made {len(opens)} broadcasts, not one at open")
    out["open_ms"], state = opens[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        broadcast_object(mesh, state)
    torch.cuda.synchronize()
    out["broadcast_ms"] = (time.perf_counter() - t0) * 1e3 / 20
    return out


def rank_main(args) -> None:
    """One of phase 17's ranks (`--rank R --port P`): the ranks share the card
    over Gloo (NCCL refuses two ranks on one device) and drive the waterfall
    points, the sharded decoder, the checkpoint cycle in `--work` (d) and the
    split decodes (e)-(g) with the batch split over them. Prints one line
    `RANK {json}` with the points, each case's kernel launches on this rank
    and its wall time (each case runs once to warm up first)."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    import labrador_ldpc_tpu_torch as T
    import torch.distributed as dist
    from labrador_ldpc_tpu_torch.ops import cuda_bf, cuda_layered
    from labrador_ldpc_tpu_torch.parallel import make_batch_mesh, make_sharded_decoder
    from labrador_ldpc_tpu_torch.parallel import mesh as pmesh
    from labrador_ldpc_tpu_torch.parallel.launch import initialize

    initialize(f"127.0.0.1:{args.port}", args.world, args.rank, backend="gloo", device="cuda")
    try:
        mesh = make_batch_mesh(device="cuda")
        out = {"rank": mesh.rank, "world": mesh.world_size, "device": str(mesh.device),
               "backend": mesh.backend}
        for key, kw, mod in (("ms", P17_MS, cuda_layered), ("bf", P17_BF, cuda_bf)):
            T.waterfall(**kw, device="cuda", mesh=mesh)  # warm: the decoder, the kernel
            torch.cuda.synchronize()
            mod.launches = 0
            pmesh.collective_calls["all_reduce"] = 0
            t0 = time.perf_counter()
            pt = T.waterfall(**kw, device="cuda", mesh=mesh)[0]
            torch.cuda.synchronize()
            out[key] = {"point": [getattr(pt, f) for f in P17_FIELDS],
                        "launches": mod.launches, "s": time.perf_counter() - t0,
                        "all_reduce": pmesh.collective_calls["all_reduce"],
                        "batches": pt.trials // kw["batch"]}
        llrs = serving_llrs(T, mesh.device)
        decode = make_sharded_decoder("TM8192", mesh, torch.float32, 50)
        decode(llrs[: 2 * mesh.world_size])  # warm
        torch.cuda.synchronize()
        cuda_layered.launches = 0
        t0 = time.perf_counter()
        res = decode(llrs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0  # before the digest's copy to the host
        out["decoder"] = {"digest": result_digest(res), "launches": cuda_layered.launches,
                          "s": wall, "frames": int(res.success.numel())}
        out["allreduce_ms"] = allreduce_ms(mesh)
        out["ckpt"] = checkpoint_cycle(T, mesh, args.work / "p17_gloo.jsonl")
        out["split"] = split_cases(T, mesh)
        print("RANK " + json.dumps(out), flush=True)
    finally:
        dist.destroy_process_group()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="a checkout of the parent commit: phases 7, 9, 13 and 14 time its "
                         "layered, sum-product, flooding and bit-flip kernels in turns with this "
                         "one's, on the same inputs")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=2, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--work", type=Path, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank is not None:
        return rank_main(args)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    import labrador_ldpc_tpu_torch as T
    from labrador_ldpc_tpu_torch.channel.awgn import _count_stats, make_trial_step
    from labrador_ldpc_tpu_torch.channel.hard import make_bf_trial_step
    from labrador_ldpc_tpu_torch.codes.expand import qc_structure
    from labrador_ldpc_tpu_torch.ops import _nvcc, cuda_bf, cuda_encoder, cuda_layered, cuda_qc, cuda_sp
    from labrador_ldpc_tpu_torch.ops.card import ctas_per_sm, sms
    from labrador_ldpc_tpu_torch.ops.bitflip import bitflip_plain
    from labrador_ldpc_tpu_torch.ops.encoder import _g_parity_f32, encode_bits_plain
    from labrador_ldpc_tpu_torch.ops.qc_minsum import flooding_minsum_plain, layered_minsum_plain
    from labrador_ldpc_tpu_torch.ops.sumproduct import layered_sp_plain

    dev = torch.device("cuda")

    # ---- 1. build -----------------------------------------------------------
    phase("1 build")
    t0 = time.perf_counter()
    sources = (cuda_layered.SOURCE, cuda_qc.SOURCE, cuda_bf.SOURCE, cuda_sp.SOURCE,
               cuda_encoder.SOURCE)
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per source, all at once
        builds = list(pool.map(_nvcc.build, sources))
    print(f"built in {time.perf_counter() - t0:.2f} s")
    templated = {cuda_layered.SOURCE: "layered_minsum_kernel", cuda_sp.SOURCE: "sumproduct_kernel",
                 cuda_qc.SOURCE: "flooding_minsum_kernel"}
    for source, b in zip(sources, builds):
        print(f"  {source}: nvcc {b.seconds:.2f} s -> {b.path.name}")
        if source in templated:
            continue
        for line in b.log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"    {line.strip()}")
    # the templated kernels' instances must not spill: the layered min-sum
    # kernel's (form x checks a thread), the sum-product kernel's (checks a
    # thread x widest row), whose phi values must stay in registers, and the
    # flooding kernel's (form x checks a thread x rows x widest row), whose
    # check statistics must, so no stack frame for either of those
    built = dict(zip(sources, builds))
    sp_regs = {}  # registers of each sum-product instance, by widest row
    layered_regs = {}  # registers of each layered min-sum instance, by (form, checks a thread)
    flood_regs = {}  # registers of each flooding instance, by (form, widest row)
    for source, kernel in templated.items():
        fns = ptxas_functions(built[source].log, kernel)
        for name, (regs, spill) in sorted(fns.items()):
            print(f"    {name}: {regs}; {spill}")
            if not re.search(r"\b0 bytes spill stores, 0 bytes spill loads", spill):
                fail(f"{name} spills registers: {spill}")
            n_regs = int(re.search(r"Used (\d+) registers", regs).group(1))
            if source == cuda_layered.SOURCE:
                form, k = name.split("<")[1].rstrip(">").split(", ")
                layered_regs[form, int(k)] = n_regs
                continue
            if not spill.startswith("0 bytes stack frame"):
                fail(f"{name} has a stack frame: {spill}")
            if source == cuda_sp.SOURCE:
                k, w = map(int, re.findall(r"\d+", name))
                if cuda_sp.INSTANCES.get(w) != k:
                    fail(f"{name} is not the instance of cuda_sp.INSTANCES for rows of {w}")
                # the card's CTAs per SM follow from them (cuda_sp.launch_config)
                sp_regs[w] = n_regs
            else:
                form = name.split("<")[1].split(",")[0]
                k, _, w = map(int, re.findall(r"\d+", name.split(",", 1)[1]))
                if cuda_qc.INSTANCES.get(w) != k:
                    fail(f"{name} is not the instance of cuda_qc.INSTANCES for rows of {w}")
                flood_regs[form, w] = n_regs
        want = {cuda_layered.SOURCE: len(cuda_layered.FORMS) * len(cuda_layered.CHECKS_PER_THREAD),
                cuda_sp.SOURCE: len(cuda_sp.INSTANCES),
                cuda_qc.SOURCE: len(cuda_layered.FORMS) * len(cuda_qc.INSTANCES)}[source]
        if len(fns) != want:
            fail(f"ptxas reported {len(fns)} {kernel} instances, want {want}")
    # the bit-flip kernel keeps its state in shared memory and a few
    # registers: no spill and no stack frame
    bf_log = built[cuda_bf.SOURCE].log
    bf_spills = [line.strip() for line in bf_log.splitlines() if "spill" in line]
    if not bf_spills or any(not line.startswith("0 bytes stack frame, 0 bytes spill stores, "
                                                "0 bytes spill loads") for line in bf_spills):
        fail(f"bitflip_kernel spills registers or has a stack frame: {bf_spills}")
    bf_regs = int(re.search(r"Used (\d+) registers", bf_log).group(1))
    # the encoder's 8 x 8 accumulators a thread stay in registers in both
    # instances (square and deep tiles): no spill and no stack frame
    enc_spills = [line.strip() for line in built[cuda_encoder.SOURCE].log.splitlines()
                  if "spill" in line]
    if len(enc_spills) != 2 or any(not line.startswith(
            "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads") for line in enc_spills):
        fail(f"encoder_kernel spills registers or has a stack frame: {enc_spills}")
    sp_sass = sass_counts(built[cuda_sp.SOURCE].path, "sumproduct_kernel", cuda_sp.INSTANCES[6], 6)
    flood_sass = flood_sass_counts(built[cuda_qc.SOURCE].path, cuda_qc.INSTANCES[6], 3, 6)
    bf_sass = bf_sass_counts(built[cuda_bf.SOURCE].path)
    parent = parent_layered = parent_sp = parent_qc = parent_bf = parent_bf_sass = None
    if args.parent is not None:
        parent = load_parent(args.parent)
        parent_layered, parent_sp = parent.ops.cuda_layered, parent.ops.cuda_sp
        parent_qc, parent_bf = parent.ops.cuda_qc, parent.ops.cuda_bf
        t0 = time.perf_counter()
        with ThreadPoolExecutor(4) as pool:  # one nvcc per source, all at once
            list(pool.map(lambda mod: mod._lib(),
                          (parent_layered, parent_sp, parent_qc, parent_bf)))
        print(f"  the parent's {cuda_layered.SOURCE}, {cuda_sp.SOURCE}, {cuda_qc.SOURCE} and "
              f"{cuda_bf.SOURCE} ({args.parent}) built and loaded in "
              f"{time.perf_counter() - t0:.2f} s")
        parent_bf_sass = parent_bf_sass_counts(parent.ops._nvcc.build(cuda_bf.SOURCE).path)
    cuda_layered._lib()  # load the libraries and declare the C signatures
    cuda_qc._lib()
    cuda_bf._lib()
    cuda_sp._lib()
    cuda_encoder._lib()
    forms = cuda_layered.FORMS  # dtype -> "f32" | "bf16" | "i8" | "i16"

    def minsum_launches() -> dict[str, int]:
        """Launches of each min-sum kernel form since the last reset."""
        out = {f"layered_minsum_{f}": n for f, n in cuda_layered.form_launches.items()}
        out.update({f"flooding_minsum_{f}": n for f, n in cuda_qc.form_launches.items()})
        return out

    # ---- 2. card ------------------------------------------------------------
    phase("2 card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    card_kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {card_kind}")
    sm_clock_mhz = int(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.split()[0])
    n_sms = sms(0)
    print(f"{n_sms} SMs, SM clock at most {sm_clock_mhz} MHz")

    # ---- 3. encoder -----------------------------------------------------------
    phase("3 encoder kernel vs golden CCSDS parity and its plain version")
    spec = importlib.util.spec_from_file_location("golden_vectors", ROOT / "tests" / "golden_vectors.py")
    golden = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(golden)
    cuda_encoder.launches = 0
    for code in T.ALL_CODES:
        data = torch.arange(code.k // 8, dtype=torch.uint8, device=dev)[None]
        cw = T.encode(code, data)
        if cw.device.type != "cuda":
            fail(f"{code}: encode did not run on the card")
        if cw[0, code.k // 8 :].cpu().numpy().tobytes() != golden.GOLDEN_PARITY[code.value]:
            fail(f"{code}: parity differs from the golden CCSDS vector")
    print(f"golden parity: 9/9 codes, {cuda_encoder.launches} launches of encoder_u8")
    if cuda_encoder.launches != len(T.ALL_CODES):
        fail("encode did not launch the encoder kernel once a call")
    g3 = torch.Generator(device=dev).manual_seed(3)
    enc_max_err = 0
    for code in T.ALL_CODES:
        for B in (1, 33, 8192, 32768):
            data = torch.randint(0, 256, (B, code.k), generator=g3, device=dev, dtype=torch.uint8)
            before = cuda_encoder.launches
            got = T.encode_bits(code, data)
            if cuda_encoder.launches != before + 1:
                fail(f"{code} B={B}: encode_bits made {cuda_encoder.launches - before} launches")
            err = int((got.int() - encode_bits_plain(code, data).int()).abs().max().item())
            enc_max_err = max(enc_max_err, err)
            if err:
                fail(f"{code} B={B}: the encoder kernel differs from its plain version")
    print("kernel == plain version: 9 codes x B in (1, 33, 8192, 32768), random bytes, one "
          "launch a call")

    def event_ms(fn, reps):
        fn()  # warm
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def kernel_device_ms(fn, kernel, reps=20):
        """Mean device time of the kernel named `kernel` over `reps` calls of
        fn, from torch.profiler: where the host takes longer a call than the
        kernel, events around back-to-back calls time the host."""
        fn()
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            torch.zeros(1, device=dev).add_(1)  # the profiler's first launch sets it up
            torch.cuda.synchronize()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        spans = [e.time_range.end - e.time_range.start for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.name]
        if len(spans) != reps:
            fail(f"torch.profiler saw {len(spans)} launches of {kernel}, want {reps}")
        return sum(spans) / reps / 1e3

    def queued_device_ms(fn, reps=20):
        """Mean device time a call of fn, all its kernels: the calls are
        queued behind a 50 ms spin kernel, so CUDA events around them time
        the device and not the host."""
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sm_clock_mhz * 50_000)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    enc_rows = {}
    for name, B in (("TM8192", 8192), ("TC512", 32768)):
        code = T.get_code(name)
        k, nk = code.k, code.n - code.k
        data = torch.randint(0, 2, (B, k), generator=g3, device=dev, dtype=torch.uint8)
        cfg = cuda_encoder.launch_config(code, B, n_sms)
        # the library route: the 0/1 product in int8 on the tensor cores
        # (torch._int_mm, the generator column-major), then & 1, the cast and
        # the concatenation; exact, since a sum is at most k
        g8 = _g_parity_f32(code, dev).to(torch.int8).t().contiguous().t()

        def library(data=data, g8=g8):
            parity = torch._int_mm(data.view(torch.int8), g8)
            return torch.cat([data, parity.bitwise_and_(1).to(torch.uint8)], dim=-1)

        if not torch.equal(library(), T.encode_bits(code, data)):
            fail(f"{name} B={B}: the int8 library route differs from the encoder kernel")
        times = [event_ms(lambda: encode_bits_plain(code, data), 5),
                 event_ms(lambda: T.encode_bits(code, data), 50),
                 event_ms(lambda: T.encode_bits(code, data), 50),
                 event_ms(lambda: encode_bits_plain(code, data), 5)]
        t_ops, t_bytes = 2 * k * nk * B / INT8_TC_OPS_PER_S, B * (k + code.n) / HBM_BYTES_PER_S
        row = {"ms": kernel_device_ms(lambda: T.encode_bits(code, data), "encoder_kernel"),
               "call_ms": min(times[1:3]), "plain_ms": min(times[0], times[3]),
               "library_ms": queued_device_ms(library), "bound_ms": 1e3 * max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
        floor_ms = 1e3 * B * nk * (k // 32) / (INT_LANES_PER_SM * n_sms * sm_clock_mhz * 1e6)
        enc_rows[name] = row
        print(f"  {name} B={B}: kernel {row['ms']:.4f} ms on the device (a call back to back "
              f"{row['call_ms']:.4f} ms; grid {cfg['groups']} x "
              f"{cfg['row_tiles']}, {cfg['bm']} x {cfg['bn']} tiles, {cfg['tiles']} a CTA, "
              f"{cfg['smem_bytes']} B), bound {row['bound_ms']:.4f} ms ({row['bound_by']}; "
              f"{100 * row['bound_ms'] / row['ms']:.2f} %), LOP3 floor {floor_ms:.4f} ms at "
              f"{sm_clock_mhz} MHz; plain {row['plain_ms']:.4f} ms, int8 torch._int_mm route "
              f"(library) {row['library_ms']:.4f} ms on the device; {smi}")

    def noisy_llrs(code, batch, ebn0_db, seed):
        rng = np.random.default_rng(seed)
        data = rng.integers(0, 2, (batch, code.k), dtype=np.uint8)
        cw = T.encode_bits(code, data).cpu().numpy()
        sigma = np.sqrt(1.0 / (2.0 * code.k / code.n * 10.0 ** (ebn0_db / 10.0)))
        llrs = (1.0 - 2.0 * cw + sigma * rng.standard_normal(cw.shape)).astype(np.float32)
        return torch.from_numpy(llrs).to(dev)

    errs: dict[str, float] = {}  # kernel form -> largest |kernel - plain| seen

    def card_noisy_llrs(code, batch, ebn0_db, seed):
        """BPSK over AWGN at Eb/N0, data and noise drawn on the card."""
        g = torch.Generator(device=dev).manual_seed(seed)
        data = torch.randint(0, 2, (batch, code.k), generator=g, device=dev, dtype=torch.uint8)
        sigma = T.noise_sigma(ebn0_db, code, "ebn0")
        noise = torch.randn((batch, code.n), generator=g, device=dev)
        return 1.0 - 2.0 * T.encode_bits(code, data).to(torch.float32) + sigma * noise

    def card_true_llrs(code, batch, ebn0_db, seed):
        """card_noisy_llrs as true LLRs 2y/sigma^2, the sum-product decoders' input."""
        sigma = T.noise_sigma(ebn0_db, code, "ebn0")
        return card_noisy_llrs(code, batch, ebn0_db, seed) * (2.0 / (sigma * sigma))

    def max_diff(got, want) -> float:
        """Largest |difference| over bits, success and iterations."""
        return float(max(
            (got.bits.int() - want.bits.int()).abs().max().item(),
            (got.iterations - want.iterations).abs().max().item(),
            (got.success.int() - want.success.int()).abs().max().item(),
        ))

    kernels = {
        "layered": (cuda_layered.layered_minsum, layered_minsum_plain),
        "flooding": (cuda_qc.flooding_minsum, flooding_minsum_plain),
    }

    def note_err(kind, dtype, err):
        name = f"{kind}_minsum_{forms[dtype]}"
        errs[name] = max(errs.get(name, 0.0), err)

    def hold(label, code, llrs, maxiters, alpha=None, kind="layered"):
        """Kernel vs plain version on the card, same inputs: identical."""
        kernel, plain = kernels[kind]
        got = kernel(code, llrs, maxiters, alpha)
        torch.cuda.synchronize()
        want = plain(qc_structure(code), llrs, maxiters, alpha)
        err = max_diff(got, want)
        note_err(kind, llrs.dtype, err)
        n_ok = int(want.success.sum())
        print(f"  {label:34s} B={llrs.shape[0]:5d} converged {n_ok:5d}  "
              f"mean iters {want.iterations.float().mean().item():6.2f}  max|diff| {err}")
        if err != 0:
            fail(f"{label}: {kind} kernel differs from its plain version")
        return got

    # ---- 4. kernel vs plain version, all nine codes ------------------------
    phase("4 layered kernel vs plain version, all nine codes")
    print("  tolerance: exact (the same float32 operations in the same order); max|diff| must be 0")
    for i, code in enumerate(T.ALL_CODES):
        llrs = noisy_llrs(code, 256, PARTIAL_EBN0[code.value], seed=40 + i)
        got = hold(f"{code} noisy", code, llrs, 20)
        if not 0 < int(got.success.sum()) < 256:
            fail(f"{code}: want a batch where some frames fail and some converge")
    # the kernel replays the alpha product when it rebuilds u_old: every code
    for c in T.ALL_CODES:
        hold(f"{c} alpha=0.8", c, noisy_llrs(c, 256, PARTIAL_EBN0[c.value] + 0.5, 7), 20, 0.8)
    for code, maxiters in (("TM8192", 1), ("TM1280", 1), ("TM5120", 0)):
        c = T.get_code(code)
        hold(f"{code} maxiters={maxiters}", c, noisy_llrs(c, 64, PARTIAL_EBN0[code], 9), maxiters)
    for code, nb in (("TM2048", 257), ("TC256", 257), ("TM6144", 1)):
        c = T.get_code(code)
        hold(f"{code} B={nb}", c, noisy_llrs(c, nb, PARTIAL_EBN0[code], 13), 20)
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
    torch.cuda.reset_peak_memory_stats(dev)
    base_bytes = torch.cuda.memory_allocated(dev)
    reset_launches()
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
    peak_bytes = torch.cuda.max_memory_allocated(dev)
    print(f"  {frames} frames verified in {wall:.3f} s ({frames / wall:.1f} frames/s end to end, "
          f"host data included); mean iteration of convergence {iters_sum / frames:.3f}")
    print(f"  per batch (CUDA events, mean of {n_batches}): " + ", ".join(
        f"{name} {ms / n_batches:.3f} ms" for name, ms in stage_ms.items()))
    print(f"  peak device memory over the {n_batches} batches (max_memory_allocated after "
          f"reset_peak_memory_stats): {peak_bytes} B ({peak_bytes / 1e9:.3f} GB; "
          f"{base_bytes} B allocated before the first batch); {smi}")
    print(f"  launches of layered_minsum_f32 on the main path: {main_launches}")
    if main_launches != n_batches or cuda_layered.form_launches["f32"] != n_batches:
        fail("the main path did not run one launch of layered_minsum_f32 per batch")

    # the same batch as 8-bit soft bits: quantize_llrs (scale 16) -> decode_ms
    if T.resolve_impl(code, torch.int8, "auto") != "cuda_layered":
        fail("impl='auto' does not resolve int8 LLRs to the CUDA kernel on the card")
    data = torch.from_numpy(batches[0]).to(dev)
    cw = T.encode(code, data)
    cw[:, 0] ^= FLIPS
    llrs_i8 = T.quantize_llrs(T.hard_to_llrs(cw, torch.float32), torch.int8)
    T.decode_ms(code, llrs_i8[:8], maxiters=maxiters)  # warm
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    res = T.decode_ms(code, llrs_i8, maxiters=maxiters, impl="auto")
    ok = bool(res.success.all()) and torch.equal(T.pack_bits(res.bits[:, : code.k]), data)
    wall = time.perf_counter() - t0
    int8_serving_launches = cuda_layered.form_launches["i8"]
    print(f"  int8 serving batch (quantize_llrs scale 16, LLR values "
          f"{sorted(llrs_i8.unique().tolist())}): {B} frames verified in {wall:.4f} s; mean iteration of convergence "
          f"{res.iterations.float().mean().item():.3f}; launches of layered_minsum_i8: "
          f"{int8_serving_launches}")
    if not ok:
        fail("an int8 serving frame did not decode to the data sent")
    if int8_serving_launches != 1 or cuda_layered.launches != 1:
        fail("the int8 serving batch did not run on one launch of layered_minsum_i8")

    # the same batch as bfloat16 LLRs: the bf16 form of the layered kernel
    if T.resolve_impl(code, torch.bfloat16, "auto") != "cuda_layered":
        fail("impl='auto' does not resolve bf16 LLRs to the CUDA kernel on the card")
    llrs_bf16 = T.hard_to_llrs(cw, torch.float32).to(torch.bfloat16)
    T.decode_ms(code, llrs_bf16[:8], maxiters=maxiters)  # warm
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    res = T.decode_ms(code, llrs_bf16, maxiters=maxiters, impl="auto")
    ok = bool(res.success.all()) and torch.equal(T.pack_bits(res.bits[:, : code.k]), data)
    wall = time.perf_counter() - t0
    bf16_serving_launches = cuda_layered.form_launches["bf16"]
    print(f"  bf16 serving batch: {B} frames verified in {wall:.4f} s; mean iteration of "
          f"convergence {res.iterations.float().mean().item():.3f}; launches of "
          f"layered_minsum_bf16: {bf16_serving_launches}, of any kernel: "
          f"{cuda_layered.launches + cuda_qc.launches + cuda_bf.launches + cuda_sp.launches}")
    if not ok:
        fail("a bf16 serving frame did not decode to the data sent")
    if bf16_serving_launches != 1 or cuda_layered.launches != 1 or \
            cuda_qc.launches + cuda_bf.launches + cuda_sp.launches:
        fail("the bf16 serving batch did not run on exactly one launch of layered_minsum_bf16")

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

    def ops_per_edge_iter(kind, dtype):
        if kind == "layered":
            return {torch.float32: OPS_PER_EDGE_ITER,
                    torch.bfloat16: OPS_PER_EDGE_ITER_BF16}.get(dtype, OPS_PER_EDGE_ITER_SAT)
        return {torch.float32: FLOOD_OPS_PER_EDGE_ITER,
                torch.bfloat16: FLOOD_OPS_PER_EDGE_ITER_BF16}.get(dtype, FLOOD_OPS_PER_EDGE_ITER_SAT)

    def measure(kind, c, llrs, label, kern_reps=10, plain_reps=2, all_converge=True):
        """Kernel and plain version in turns (plain, kernel, kernel, plain)
        on (B, n) LLRs of code c (with --parent, the parent's kernel of the
        same kind too: plain, parent, kernel, kernel, parent, plain); returns
        the numbers of one row."""
        kernel, plain_fn = kernels[kind]
        s = qc_structure(c)
        plain = lambda: plain_fn(s, llrs, maxiters)  # noqa: E731
        kern = lambda: kernel(c, llrs, maxiters)  # noqa: E731
        old_fn = {"layered": parent_layered and parent_layered.layered_minsum,
                  "flooding": parent_qc and parent_qc.flooding_minsum}[kind]
        old = old_fn and (lambda: old_fn(c.value, llrs, maxiters))  # its own codes
        plain_a, want = time_ms(plain, plain_reps)
        if old:
            parent_a, prev = time_ms(old, kern_reps)
        kern_a, got = time_ms(kern, kern_reps)
        kern_b, _ = time_ms(kern, kern_reps)
        if old:
            parent_b, _ = time_ms(old, kern_reps)
        plain_b, _ = time_ms(plain, plain_reps)
        err = max_diff(got, want)
        note_err(kind, llrs.dtype, err)
        if err != 0 or (all_converge and not bool(got.success.all())):
            fail(f"{label}: kernel differs from its plain version, or a frame failed")
        # work this data needs: a converged codeword ran iterations+1 sweeps,
        # a failed one maxiters
        sweeps = int(torch.where(got.success, got.iterations + 1, got.iterations).sum())
        p = c.params
        nb = llrs.shape[0]
        io_bytes = nb * p.n * llrs.element_size() + nb * p.n_vars + nb + nb * 4
        ops = ops_per_edge_iter(kind, llrs.dtype) * p.paritycheck_sum * sweeps
        bytes_ms, ops_ms = io_bytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
        row = dict(
            ms=min(kern_a, kern_b), plain_ms=min(plain_a, plain_b),
            bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        )
        print(f"  {label}: kernel {kern_a:.4f} / {kern_b:.4f} ms per decode -> "
              f"{nb / row['ms'] * 1e3:.1f} cw/s; plain {plain_a:.4f} / {plain_b:.4f} ms")
        if old:
            row["parent_ms"] = min(parent_a, parent_b)
            print(f"  {label}: parent's kernel {parent_a:.4f} / {parent_b:.4f} ms per decode "
                  f"(max|diff| against the plain version {max_diff(prev, want)}); kernel/parent "
                  f"{row['ms'] / row['parent_ms']:.4f}")
        print(f"  {label}: converged {int(got.success.sum())}/{nb}; sweeps {sweeps} (mean "
              f"{sweeps / nb:.3f} per codeword); in/out bytes {io_bytes}; ops {ops}; bound "
              f"{row['bound_ms']:.4f} ms (bytes {bytes_ms:.4f} ms, operations {ops_ms:.4f} ms)")
        if kind == "layered":
            # the shape with the syndrome's work a sweep: check words and windows
            print(f"  {label}: launch shape {layered_shape(c, llrs.dtype)}")
            return row
        print(f"  {label}: launch shape {flood_shape(c, llrs.dtype)}")
        if c.value == "TM8192" and llrs.dtype == torch.float32 and flood_sass:
            # its SASS per edge visit at one warp instruction a clock on each
            # of an SM's four schedulers
            instr = flood_sass["sweep 1"] + flood_sass["sweep 2"]
            edge_iters = p.paritycheck_sum * sweeps
            issue_ms = instr * edge_iters / 32 / (4 * n_sms * sm_clock_mhz * 1e6) * 1e3
            row["issue_ms"] = issue_ms
            print(f"  {label}: SASS issue floor {issue_ms:.4f} ms ({instr:.2f} instructions an "
                  f"edge visit, {edge_iters} edge visits, {n_sms} SMs at {sm_clock_mhz} MHz, 4 "
                  f"warp instructions an SM a clock); kernel/issue floor "
                  f"{row['ms'] / issue_ms:.3f}")
        return row

    def flood_shape(c, dtype) -> dict:
        """The flooding kernel's launch shape for code c and a dtype form at
        ptxas's registers of its instance, with sweep 1's runs and the
        barriers per iteration; fails unless the card's occupancy calculator
        gives launch_config's CTAs per SM."""
        regs = flood_regs[forms[dtype], max(len(row) for row in qc_structure(c).rows)]
        cfg = cuda_qc.launch_config(c, dtype, registers=regs)
        card = cuda_qc.card_ctas_per_sm(c, dtype)
        if card != cfg["ctas_per_sm"]:
            fail(f"{c} flooding {forms[dtype]}: {card} CTAs per SM on the card, launch_config at "
                 f"{regs} registers says {cfg['ctas_per_sm']}")
        return dict(cfg, registers=regs)

    def layered_shape(c, dtype) -> dict:
        """The layered kernel's launch shape for code c and a dtype form, its
        CTAs per SM as the card's occupancy calculator reports them; fails
        unless that equals the count of the one occupancy rule at ptxas's
        registers of its instance (`card.ctas_per_sm`, as phase 15 holds it),
        which is never below launch_config's at the 64-register budget."""
        cfg = cuda_layered.launch_config(c, dtype)
        regs = layered_regs[forms[dtype], cfg["checks_per_thread"]]
        want = ctas_per_sm(cfg["smem_bytes"], cfg["threads"], regs)
        on_card = cuda_layered.card_ctas_per_sm(c, dtype)
        if on_card != want or on_card < cfg["ctas_per_sm"]:
            fail(f"{c} {forms[dtype]}: {on_card} CTAs per SM on the card, {want} at ptxas's "
                 f"{regs} registers, launch_config says {cfg['ctas_per_sm']} at 64")
        return dict(cfg, registers=regs, card_ctas_per_sm=on_card)

    print("  layered kernel launch shapes (threads, checks a thread, shared bytes, CTAs per SM "
          "from cudaOccupancyMaxActiveBlocksPerMultiprocessor == at ptxas's registers, and "
          "launch_config's at 64; syndrome check words and windows a sweep):")
    for c in T.ALL_CODES:
        print(f"    {c.value:6s} " + "; ".join(
            f"{forms[dt]} {cfg['threads']}x{cfg['checks_per_thread']} {cfg['smem_bytes']} B "
            f"{cfg['card_ctas_per_sm']}/SM ({cfg['ctas_per_sm']} at 64)"
            for dt in forms for cfg in [layered_shape(c, dt)])
            + "; syndrome {syndrome_words} words from {syndrome_windows} windows".format(
                **cuda_layered.launch_config(c)))

    def three_flip_llrs(c, data_np, dtype=torch.float32):
        cw = T.encode(c, torch.from_numpy(data_np).to(dev))
        cw[:, 0] ^= FLIPS
        llrs = T.hard_to_llrs(cw, torch.float32)
        return T.quantize_llrs(llrs, dtype) if dtype in (torch.int8, torch.int16) else llrs.to(dtype)

    # the main path: TM8192, the TPU kernel B1's shape
    rows = {"layered_minsum_f32": measure("layered", code, three_flip_llrs(code, batches[0]),
                                          f"{code} layered f32")}
    main_row = rows["layered_minsum_f32"]
    c = T.get_code("TM1536")  # an M <= 256 code: the shape of the TPU kernel B2
    measure("layered", c, three_flip_llrs(
        c, np.random.default_rng(1).integers(0, 256, (B, c.k // 8), dtype=np.uint8)),
        f"{c} layered f32")
    # the quantized-LLR and bf16 forms and the flooding kernel (B3's shape) on
    # the same 3-flip batch, quantized with the default scales or cast
    families = (("layered", (torch.int8, torch.int16, torch.bfloat16)),
                ("flooding", (torch.float32, torch.bfloat16, torch.int8, torch.int16)))
    for family, dtypes in families:
        for dt in dtypes:
            rows[f"{family}_minsum_{forms[dt]}"] = measure(
                family, code, three_flip_llrs(code, batches[0], dt), f"{code} {family} {forms[dt]}")
    # every new form at TM1536 too: an M <= 256 code, the shape of B2 and B4
    c = T.get_code("TM1536")
    data_b2 = np.random.default_rng(1).integers(0, 256, (B, c.k // 8), dtype=np.uint8)
    for family, dtypes in families:
        for dt in dtypes:
            measure(family, c, three_flip_llrs(c, data_b2, dt), f"{c} {family} {forms[dt]}")
    # flooding float32 where it works hard: Eb/N0 1.1 dB (the waterfall point)
    flood_1p1 = measure("flooding", code, card_noisy_llrs(code, B, 1.1, seed=110),
                        f"{code} flooding f32 at 1.1 dB", kern_reps=3, plain_reps=1,
                        all_converge=False)
    # the layered kernel where the benchmark runs it: the f32 stream's Eb/N0
    # (about 20 sweeps a frame) and TC512 at a waterfall batch of 32,768
    layered_1p5 = measure("layered", code, card_noisy_llrs(code, B, 1.5, seed=150),
                          f"{code} layered f32 at 1.5 dB", kern_reps=3, plain_reps=1,
                          all_converge=False)
    c = T.get_code("TC512")
    layered_tc512 = measure("layered", c, card_noisy_llrs(c, 2 * B, 1.5, seed=151),
                            f"{c} layered f32 at 1.5 dB", kern_reps=5, plain_reps=1,
                            all_converge=False)

    bf_max_err = 0.0

    def bf_shape(c) -> dict:
        """The bit-flip kernel's launch shape for code c at ptxas's registers;
        fails unless the card's occupancy calculator gives launch_config's
        CTAs per SM."""
        cfg = cuda_bf.launch_config(c, registers=bf_regs)
        card = cuda_bf.card_ctas_per_sm(c)
        if card != cfg["ctas_per_sm"]:
            fail(f"{c} bit-flip: {card} CTAs per SM on the card, launch_config at {bf_regs} "
                 f"registers says {cfg['ctas_per_sm']}")
        return dict(cfg, registers=bf_regs)

    def measure_bf(label, c, hard, mi):
        """Bit-flip kernel and its plain version in turns on (B, n) hard bits
        of code c (with --parent, the parent's kernel too: plain, parent,
        kernel, kernel, parent, plain); returns the numbers of one row."""
        nonlocal bf_max_err
        s = qc_structure(c)
        plain = lambda: bitflip_plain(s, hard, mi)  # noqa: E731
        kern = lambda: cuda_bf.bitflip(c, hard, mi)  # noqa: E731
        old = parent_bf and (lambda: parent_bf.bitflip(c.value, hard, mi))  # its own codes
        plain_a, want = time_ms(plain, 2)
        if old:
            parent_a, prev = time_ms(old, 10)
        kern_a, got = time_ms(kern, 10)
        kern_b, _ = time_ms(kern, 10)
        if old:
            parent_b, _ = time_ms(old, 10)
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
        old_ops = sweeps * (BF_OPS_PER_EDGE_ITER * E + BF_OPS_PER_VAR_ITER * V)
        if p.punctured_bits and mi > 0:
            old_ops += nb * BF_OPS_ERASURE_PER_EDGE * E
        ops = -(-old_ops // BF_BITS_PER_OP)
        bytes_ms, ops_ms = io_bytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
        row = dict(
            ms=min(kern_a, kern_b), plain_ms=min(plain_a, plain_b),
            bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        )
        n_ok = int(got.success.sum())
        print(f"  {label}: kernel {kern_a:.4f} / {kern_b:.4f} ms per decode -> "
              f"{nb / row['ms'] * 1e3:.1f} cw/s; plain {plain_a:.4f} / {plain_b:.4f} ms")
        if old:
            row["parent_ms"] = min(parent_a, parent_b)
            print(f"  {label}: parent's kernel {parent_a:.4f} / {parent_b:.4f} ms per decode "
                  f"(max|diff| against the plain version {max_diff(prev, want)}); kernel/parent "
                  f"{row['ms'] / row['parent_ms']:.4f}")
        print(f"  {label}: converged {n_ok}/{nb}; sweeps {sweeps} (mean {sweeps / nb:.3f}, "
              f"max {int(per_cw.max())} per codeword); in/out bytes {io_bytes}; int ops {ops} "
              f"(32 bits an operation; the parent design's operations {old_ops}, "
              f"{old_ops / F32_OPS_PER_S * 1e3:.4f} ms); bound {row['bound_ms']:.4f} ms (bytes "
              f"{bytes_ms:.4f} ms, operations {ops_ms:.4f} ms at {F32_OPS_PER_S:.3g}/s)")
        print(f"  {label}: launch shape {bf_shape(c)}")
        rate = 4 * n_sms * sm_clock_mhz * 1e6  # warp instructions an SM a clock, all SMs
        windows = sweeps * sum(map(len, s.rows)) * max(1, s.m // 32)  # of each kind
        if bf_sass:
            # a warp instruction serves 32 windows (32 lanes); the erasure
            # vote's windows, packing, the per-word work and the flip are not
            # counted. Nearly all of a window's instructions are integer ones,
            # which an SM runs on 64 lanes a clock: two warp instructions
            issue_ms = windows * (bf_sass["parity"] + bf_sass["count"]) / 32 / rate * 1e3
            row["issue_ms"] = issue_ms
            print(f"  {label}: SASS issue floor {issue_ms:.4f} ms ({windows} parity and {windows} "
                  f"count windows at {bf_sass['parity']} and {bf_sass['count']} instructions, "
                  f"{n_sms} SMs at {sm_clock_mhz} MHz, 4 warp instructions an SM a clock), "
                  f"{2 * issue_ms:.4f} ms at the integer pipe's 2; kernel/issue floor "
                  f"{row['ms'] / issue_ms:.3f}")
        if old and parent_bf_sass:
            visits = 2 * sweeps * E  # an edge visit in the parity and in the count sweep
            parent_issue = visits * parent_bf_sass / 32 / rate * 1e3
            print(f"  {label}: the parent's SASS issue floor {parent_issue:.4f} ms ({visits} edge "
                  f"visits at {parent_bf_sass:.2f} instructions); parent/its floor "
                  f"{row['parent_ms'] / parent_issue:.3f}; SM clocks a codeword-sweep of the "
                  f"parent {row['parent_ms'] * 1e-3 * n_sms * sm_clock_mhz * 1e6 / sweeps:.0f}")
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

    sp_max_err = 0.0

    def measure_sp(label, c, llrs, mi):
        """The sum-product kernel and its plain version in turns on (B, n) true
        LLRs of code c (with --parent, the parent's kernel too: plain, parent,
        kernel, kernel, parent, plain); returns the numbers of one row."""
        nonlocal sp_max_err
        s = qc_structure(c)
        plain = lambda: layered_sp_plain(s, llrs, mi)  # noqa: E731
        kern = lambda: cuda_sp.layered_sp(c, llrs, mi)  # noqa: E731
        old = parent_sp and (lambda: parent_sp.layered_sp(c.value, llrs, mi))  # its own codes
        plain_a, want = time_ms(plain, 1)
        if old:
            parent_a, prev = time_ms(old, 3)
        kern_a, got = time_ms(kern, 3)
        kern_b, _ = time_ms(kern, 3)
        if old:
            parent_b, _ = time_ms(old, 3)
        plain_b, _ = time_ms(plain, 1)
        err = max_diff(got, want)
        sp_max_err = max(sp_max_err, err)
        if err != 0:
            fail(f"{label}: sum-product kernel differs from its plain version")
        per_cw = torch.where(got.success, got.iterations + 1, got.iterations)
        sweeps = int(per_cw.sum())
        p = c.params
        nb = llrs.shape[0]
        io_bytes = nb * p.n * 4 + nb * p.n_vars + 5 * nb
        edge_iters = p.paritycheck_sum * sweeps
        ops = SP_OPS_PER_EDGE_ITER * edge_iters
        bytes_ms, ops_ms = io_bytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
        row = dict(
            ms=min(kern_a, kern_b), plain_ms=min(plain_a, plain_b),
            bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        )
        print(f"  {label}: kernel {kern_a:.4f} / {kern_b:.4f} ms per decode -> "
              f"{nb / row['ms'] * 1e3:.1f} cw/s; plain {plain_a:.4f} / {plain_b:.4f} ms")
        if old:
            print(f"  {label}: parent's kernel {parent_a:.4f} / {parent_b:.4f} ms per decode "
                  f"(max|diff| against the plain version {max_diff(prev, want)}); kernel/parent "
                  f"{row['ms'] / min(parent_a, parent_b):.4f}")
        print(f"  {label}: converged {int(got.success.sum())}/{nb}; sweeps {sweeps} (mean "
              f"{sweeps / nb:.3f}, max {int(per_cw.max())} per codeword); in/out bytes "
              f"{io_bytes}; ops {ops}; bound {row['bound_ms']:.4f} ms (bytes {bytes_ms:.4f} ms, "
              f"operations {ops_ms:.4f} ms)")
        print(f"  {label}: launch shape {sp_shape(c)}")
        if c.value == "TM8192" and sp_sass:
            # what bounds the kernel: its SASS per edge visit at one warp
            # instruction a clock on each of an SM's four schedulers, and its
            # MUFU instructions (two phi an edge) at 16 an SM a clock
            instr = sp_sass["pass 1"] + sp_sass["pass 2"] + sp_sass["syndrome"]
            rate = n_sms * sm_clock_mhz * 1e6
            issue_ms = instr * edge_iters / 32 / (4 * rate) * 1e3
            mufu = 2 * sum(sp_sass["mufu_per_phi"].values())
            mufu_ms = mufu * edge_iters / (16 * rate) * 1e3
            print(f"  {label}: SASS issue floor {issue_ms:.4f} ms ({instr:.2f} instructions an "
                  f"edge visit, {edge_iters} edge visits, {n_sms} SMs at {sm_clock_mhz} MHz, 4 "
                  f"warp instructions an SM a clock); MUFU floor {mufu_ms:.4f} ms ({mufu:.2f} an "
                  f"edge visit); kernel/issue floor {row['ms'] / issue_ms:.3f}")
        return row

    def sp_shape(c) -> dict:
        """The sum-product kernel's launch shape for code c and its barriers
        per iteration; fails unless the card's occupancy calculator gives
        launch_config's CTAs per SM."""
        regs = sp_regs[max(len(row) for row in qc_structure(c).rows)]
        cfg = cuda_sp.launch_config(c, registers=regs)
        card = cuda_sp.card_ctas_per_sm(c)
        if card != cfg["ctas_per_sm"]:
            fail(f"{c} sum-product: {card} CTAs per SM on the card, launch_config at {regs} "
                 f"registers says {cfg['ctas_per_sm']}")
        s = qc_structure(c)
        runs = len({(int(lo) >> 19) & 63 for lo, _ in cuda_layered.addend_descriptors(s)})
        return dict(cfg, registers=regs, barriers_per_iteration=s.n_block_rows + runs + 1)

    # the sum-product slice's shapes: TM8192 at its waterfall anchor (the TPU
    # kernel B7's shape, M >= 512), TM1536 (M <= 256, where the JAX package
    # serves the XLA twin)
    sp_row = measure_sp("TM8192 sum-product 0.9 dB, B=8192, maxiters=100", code,
                        card_true_llrs(code, 8192, 0.9, seed=90), 100)
    c = T.get_code("TM1536")
    measure_sp("TM1536 sum-product 2.0 dB, B=8192, maxiters=100", c,
               card_true_llrs(c, 8192, 2.0, seed=91), 100)
    print("  no single PyTorch call computes any of these decodes: library_ms is null")

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
    # hard bits that start one byte into their buffer: the wrapper copies
    # them to an aligned one for the kernel's 16-byte loads
    for name in ("TM8192", "TC128"):
        c = T.get_code(name)
        sent = hard_batch(c, 65, 15)
        buf = torch.empty(sent.numel() + 1, dtype=torch.uint8, device=dev)
        hard = buf[1:].view(sent.shape)
        hard.copy_(sent)
        if hard.data_ptr() % cuda_bf.INPUT_ALIGN == 0:
            fail("the misaligned batch is aligned")
        hold_bf(f"{name} misaligned by 1 B", c, hard, 20)
    print("  bit-flip launch shapes (lanes a codeword, codewords a CTA, shared bytes, CTAs per SM "
          "from cudaOccupancyMaxActiveBlocksPerMultiprocessor == launch_config at ptxas's "
          "registers):")
    for c in T.ALL_CODES:
        cfg = bf_shape(c)
        print(f"    {c.value:6s} {cfg['threads']} threads: {cfg['lanes']} lanes x "
              f"{cfg['codewords_per_cta']} codewords, {cfg['smem_bytes']} B, "
              f"{cfg['ctas_per_sm']}/SM at {cfg['registers']} registers")
    c = T.get_code("TM1536")
    hard = hard_batch(c, 64, 11)
    on_card = cuda_bf.bitflip(c, hard, 20)
    on_cpu = bitflip_plain(qc_structure(c), hard.cpu(), 20)
    if not all(torch.equal(a.cpu(), b) for a, b in zip(on_card, on_cpu)):
        fail("bit-flip kernel on the card differs from the plain version on the CPU")
    print("  TM1536 kernel on the card == plain version on the CPU")

    # ---- 9. the hard-decision slice's path -----------------------------------------
    phase("9 slice path: waterfall(device='cuda'), TM8192, batch 8192, one batch per point")

    def stored_frame_errors(fname, x, batch, column=6):
        with open(ROOT / "benchmarks" / "results" / fname) as f:
            for row in csv.reader(f):
                if row and not row[0].startswith("#") and row[0] == "TM8192" and float(row[1]) == x:
                    return int(row[column]) / int(row[2]) * batch
        fail(f"{fname} has no TM8192 row at {x}")

    torch.cuda.synchronize()
    cuda_bf.launches = 0
    cuda_layered.launches = 0
    cuda_encoder.launches = 0
    points = []
    for decoder, model, x, mi, fname in WATERFALL_POINTS:
        (pt,) = T.waterfall(code, [x], batch=8192, maxiters=mi, max_bits=1,
                            max_bit_errors=10**9, noise_model=model, decoder=decoder, seed=0)
        points.append((decoder, model, mi, fname, pt))
    slice_launches = dict(bitflip_u8=cuda_bf.launches, layered_minsum_f32=cuda_layered.launches,
                          encoder_u8=cuda_encoder.launches)
    # every batch the points drained was encoded by one launch of the kernel
    slice_batches = sum(pt.trials for *_, pt in points) // 8192
    for decoder, model, mi, fname, pt in points:
        want = stored_frame_errors(fname, pt.snr_db, pt.trials)
        print(f"  {decoder:2s} {model:5s} maxiters={mi:3d}: {pt.csv()}  frame errors "
              f"{pt.frame_errors} vs stored {want:.0f} ({fname}); decode failures "
              f"{pt.decode_failures}; mean iterations {pt.iterations / pt.trials:.2f}; "
              f"{pt.trials / pt.elapsed_s:.1f} cw/s end to end (host clock, data made on the card)")
        if pt.trials != 8192 or not want / BAND <= pt.frame_errors <= want * BAND:
            fail(f"{decoder} {model} {pt.snr_db}: {pt.frame_errors} frame errors, outside a "
                 f"factor {BAND} of the stored {want:.0f}")
        if decoder == "bf" and parent is not None:
            # the parent's bit-flip kernel on the same draws
            (old,) = parent.waterfall(code.value, [pt.snr_db], batch=8192, maxiters=mi,
                                      max_bits=1, max_bit_errors=10**9, noise_model=model,
                                      decoder=decoder, seed=0)
            print(f"  {decoder:2s} {model:5s} the parent's kernel on the same draws: frame errors "
                  f"{old.frame_errors}, bit errors {old.bit_errors} (this kernel "
                  f"{pt.bit_errors}), {old.trials / old.elapsed_s:.1f} cw/s end to end")
            if old.frame_errors != pt.frame_errors or old.bit_errors != pt.bit_errors:
                fail(f"{decoder} {model}: the parent's kernel and this one differ on the same "
                     "draws")
    print(f"  launches on the slice's path: {slice_launches}; {slice_batches} batches drained")
    if min(slice_launches.values()) < 1:
        fail("the waterfall did not launch all three CUDA kernels")
    if slice_launches["encoder_u8"] != slice_batches:
        fail(f"the waterfall encoded {slice_batches} batches with "
             f"{slice_launches['encoder_u8']} launches of encoder_u8, want one a batch")

    # the quantized-LLR slice: int8/int16 through "auto" (the layered
    # kernel's int forms) and "cuda_qc" (the flooding kernel) at 1.1 dB
    int_launches = {f"{kind}_minsum_{form}": 0 for kind in kernels for form in forms.values()}
    for impl, dtype_name, fname in INT_WATERFALL_POINTS:
        torch.cuda.synchronize()
        reset_launches()
        (pt,) = T.waterfall(code, [1.1], batch=8192, maxiters=100, max_bits=1,
                            max_bit_errors=10**9, noise_model="ebn0", dtype_name=dtype_name,
                            impl=impl, seed=0)
        point_launches = minsum_launches()
        want_kernel = ("layered" if impl == "auto" else "flooding") + "_minsum_" + \
            forms[getattr(torch, dtype_name)]
        want = stored_frame_errors(fname, 1.1, pt.trials, column=7)
        print(f"  {impl:7s} {dtype_name:7s} maxiters=100: {pt.csv()}  frame errors "
              f"{pt.frame_errors} vs stored {want:.0f} ({fname}); decode failures "
              f"{pt.decode_failures}; mean iterations {pt.iterations / pt.trials:.2f}; "
              f"{pt.trials / pt.elapsed_s:.1f} cw/s end to end (host clock, data made on the "
              f"card); launches {dict((k, v) for k, v in point_launches.items() if v)}")
        if pt.trials != 8192 or not want / BAND <= pt.frame_errors <= want * BAND:
            fail(f"{impl} {dtype_name} 1.1 dB: {pt.frame_errors} frame errors, outside a factor "
                 f"{BAND} of the stored {want:.0f}")
        if point_launches[want_kernel] < 1 or sum(point_launches.values()) != \
                point_launches[want_kernel]:
            fail(f"{impl} {dtype_name}: the waterfall did not run on {want_kernel} alone")
        if impl == "cuda_qc" and parent is not None:
            # the parent's flooding kernel on the same draws
            (old,) = parent.waterfall(code.value, [1.1], batch=8192, maxiters=100, max_bits=1,
                                      max_bit_errors=10**9, noise_model="ebn0",
                                      dtype_name=dtype_name, impl=impl, seed=0)
            print(f"  {impl:7s} {dtype_name:7s} the parent's kernel on the same draws: frame "
                  f"errors {old.frame_errors}, {old.trials / old.elapsed_s:.1f} cw/s end to end")
            if old.frame_errors != pt.frame_errors or old.bit_errors != pt.bit_errors:
                fail(f"{impl} {dtype_name}: the parent's kernel and this one differ on the same "
                     "draws")
        for name, n in point_launches.items():
            int_launches[name] += n

    # the bf16 slice: bf16 "auto" (the layered kernel's bf16 form) and
    # "cuda_qc" (the flooding kernel's) at 1.1 dB, each beside float32 on the
    # same draws (the waterfall's generators depend on the seed and the batch
    # index only) and held to the stored float32 record of its schedule
    bf16_launches = {}
    for impl, kernel_form, fname, column, count in BF16_WATERFALL_POINTS:
        pts = {}
        for dtype_name in ("float32", "bfloat16"):
            torch.cuda.synchronize()
            reset_launches()
            (pts[dtype_name],) = T.waterfall(code, [1.1], batch=8192, maxiters=100, max_bits=1,
                                             max_bit_errors=10**9, noise_model="ebn0",
                                             dtype_name=dtype_name, impl=impl, seed=0)
            if dtype_name == "bfloat16":
                point_launches = minsum_launches()
        pt, pt32 = pts["bfloat16"], pts["float32"]
        want = stored_frame_errors(fname, 1.1, pt.trials, column=column)
        got, got32 = getattr(pt, count), getattr(pt32, count)
        print(f"  {impl:7s} bfloat16 maxiters=100: {pt.csv()}  {count} {got} vs stored float32 "
              f"{want:.0f} ({fname}); the card's float32 on the same draws {got32} (bf16/f32 "
              f"{got / got32:.4f}); frame errors {pt.frame_errors} (f32 {pt32.frame_errors}); "
              f"decode failures {pt.decode_failures}; mean iterations "
              f"{pt.iterations / pt.trials:.2f} (f32 {pt32.iterations / pt32.trials:.2f}); "
              f"{pt.trials / pt.elapsed_s:.1f} cw/s end to end (f32 "
              f"{pt32.trials / pt32.elapsed_s:.1f}); launches "
              f"{dict((k, v) for k, v in point_launches.items() if v)}")
        if pt.trials != 8192 or not want / BAND <= got <= want * BAND:
            fail(f"{impl} bfloat16 1.1 dB: {got} {count}, outside a factor {BAND} of the stored "
                 f"float32 {want:.0f}")
        if point_launches[kernel_form] != 1 or sum(point_launches.values()) != 1:
            fail(f"{impl} bfloat16: the waterfall did not run on one launch of {kernel_form}")
        bf16_launches[kernel_form] = point_launches[kernel_form]

    def stage_times(label, step, param):
        """Where one batch's time goes: the trial step's stages, CUDA events."""
        stages = ("draw", "encode", "channel", "decode", "count")
        g = torch.Generator(device=dev).manual_seed(1)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(stages) + 1)]
        torch.cuda.synchronize()
        ev[0].record()
        data, noise = step.draw(g, param)
        ev[1].record()
        cw_bits = T.encode_bits(step.code, data)
        ev[2].record()
        x = step.channel(cw_bits, noise, param)
        ev[3].record()
        res = step.decoder(x)
        ev[4].record()
        _count_stats(step.batch, step.code.k, data, res).frame_errors.item()
        ev[5].record()
        torch.cuda.synchronize()
        ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(len(stages))]
        print(f"  one batch of {label} (CUDA events): " + ", ".join(
            f"{name} {t:.3f} ms" for name, t in zip(stages, ms)) + f"; total {sum(ms):.3f} ms")

    stage_times("bf bsc 0.006", make_bf_trial_step(code, 8192, 50, "bsc"), 0.006)
    stage_times("ms ebn0 1.0 dB", make_trial_step(code, 8192, 100), T.noise_sigma(1.0, code, "ebn0"))
    stage_times("ms int8 ebn0 1.1 dB", make_trial_step(code, 8192, 100, "int8"),
                T.noise_sigma(1.1, code, "ebn0"))

    # ---- 10, 11. the int forms of the layered kernel, the flooding kernel --------
    def quantized(llrs, dtype, seed, full_range=True):
        """llrs as `dtype`: float32 as they are, bf16 cast, ints through
        quantize_llrs with an eighth of the rows uniform over the whole int
        range."""
        if dtype not in (torch.int8, torch.int16):
            return llrs.to(dtype)
        q = T.quantize_llrs(llrs, dtype)
        info = torch.iinfo(dtype)
        g = torch.Generator(device=dev).manual_seed(seed)
        rows = q.shape[0] // 8 if full_range else 0
        q[:rows] = torch.randint(info.min, info.max + 1, (rows, q.shape[1]), generator=g,
                                 device=dev, dtype=torch.int32).to(dtype)
        return q

    def mixed(c, batch, seed):
        """Half the rows 1 dB below the code's partial-convergence point (most
        fail), half 1.5 dB above it (most converge)."""
        lo = card_noisy_llrs(c, batch - batch // 2, PARTIAL_EBN0[c.value] - 1.0, seed)
        hi = card_noisy_llrs(c, batch // 2, PARTIAL_EBN0[c.value] + 1.5, seed + 1)
        return torch.cat([lo, hi])

    def corners(kind, dtypes):
        for i, c in enumerate(T.ALL_CODES):
            for dt in dtypes:
                got = hold(f"{c} {kind} {forms[dt]} mixed", c, quantized(mixed(c, 256, 80 + i), dt,
                                                                          i), 20, kind=kind)
                if not 0 < int(got.success.sum()) < 256:
                    fail(f"{c} {forms[dt]}: want a batch where some frames fail and some converge")
        for dt in dtypes:
            for name in ("TM8192", "TC128"):
                c = T.get_code(name)
                clean = quantized(card_noisy_llrs(c, 64, 100.0, 5).sign(), dt, 0, False)
                got = hold(f"{name} {kind} {forms[dt]} clean", c, clean, 20, kind=kind)
                if not bool(got.success.all()):
                    fail(f"{name} {forms[dt]}: clean codewords must converge")
            for name in ("TM1280", "TM8192"):
                c = T.get_code(name)
                for mi in (0, 1):
                    got = hold(f"{name} {kind} {forms[dt]} maxiters={mi}", c,
                               quantized(mixed(c, 64, 9), dt, 9), mi, kind=kind)
                    if mi == 0 and (bool(got.bits.any()) or bool(got.success.any())):
                        fail(f"{name}: at maxiters=0 the bits stay 0 and nothing converges")
            for name, nb in (("TM2048", 257), ("TC256", 257), ("TM6144", 1)):
                c = T.get_code(name)
                hold(f"{name} {kind} {forms[dt]} B={nb}", c, quantized(mixed(c, nb, 13), dt, 13),
                     20, kind=kind)
            c = T.get_code("TM1536")
            x = quantized(mixed(c, 64, 11), dt, 11)
            on_card = kernels[kind][0](c, x, 20)
            on_cpu = kernels[kind][1](qc_structure(c), x.cpu(), 20)
            if not all(torch.equal(a.cpu(), b) for a, b in zip(on_card, on_cpu)):
                fail(f"{kind} {forms[dt]} kernel on the card differs from the plain version on "
                     "the CPU")
            print(f"  TM1536 {kind} {forms[dt]} kernel on the card == plain version on the CPU")

    def bf16_alpha(kind):
        for name in ("TM8192", "TC256"):
            c = T.get_code(name)
            hold(f"{name} {kind} bf16 alpha=0.8", c, mixed(c, 256, 7).to(torch.bfloat16), 20, 0.8,
                 kind=kind)

    phase("10 layered kernel, int8/int16/bf16 forms, vs plain version on the card")
    print("  tolerance: exact (integer arithmetic; bf16: the same float32 operations and "
          "bfloat16 roundings in the same order); max|diff| must be 0")
    corners("layered", (torch.int8, torch.int16, torch.bfloat16))
    bf16_alpha("layered")

    phase("11 flooding kernel vs plain version on the card")
    print("  tolerance: exact (the same float32 operations and bfloat16 roundings in the same "
          "order; integer arithmetic); max|diff| must be 0")
    corners("flooding", (torch.float32, torch.bfloat16, torch.int8, torch.int16))
    for name in ("TM8192", "TC256"):
        c = T.get_code(name)
        hold(f"{name} flooding f32 alpha=0.8", c, mixed(c, 256, 7), 20, 0.8, kind="flooding")
    bf16_alpha("flooding")
    print("  flooding kernel launch shapes (threads x checks a thread, shared bytes, CTAs per SM "
          "from cudaOccupancyMaxActiveBlocksPerMultiprocessor == launch_config at ptxas's "
          "registers; sweep-1 runs and barriers an iteration):")
    for c in T.ALL_CODES:
        cfgs = {dt: flood_shape(c, dt) for dt in forms}
        print(f"    {c.value:6s} " + "; ".join(
            f"{forms[dt]} {cfg['threads']}x{cfg['checks_per_thread']} {cfg['smem_bytes']} B "
            f"{cfg['ctas_per_sm']}/SM at {cfg['registers']} registers" for dt, cfg in cfgs.items())
            + f"; {cfgs[torch.float32]['runs']} runs, "
              f"{cfgs[torch.float32]['barriers_per_iteration']} barriers an iteration")

    # ---- 12. the sum-product kernel ------------------------------------------------
    phase("12 layered sum-product kernel vs plain version on the card")
    print("  tolerance: exact (the same float32 operations in the same order, the CUDA math "
          "library's expf/logf on both sides); max|diff| must be 0")

    def hold_sp(label, c, llrs, mi):
        nonlocal sp_max_err
        got = cuda_sp.layered_sp(c, llrs, mi)
        torch.cuda.synchronize()
        want = layered_sp_plain(qc_structure(c), llrs, mi)
        err = max_diff(got, want)
        sp_max_err = max(sp_max_err, err)
        print(f"  {label:28s} B={llrs.shape[0]:5d} converged {int(want.success.sum()):5d}  "
              f"mean iters {want.iterations.float().mean().item():6.2f}  max|diff| {err}")
        if err != 0:
            fail(f"{label}: sum-product kernel differs from its plain version")
        return got

    def sp_mixed(c, batch, seed):
        """True LLRs: a third 1 dB below the code's partial-convergence point
        of min-sum (most fail), a third at it, a third 1 dB above (most
        converge)."""
        k = batch // 3
        parts = ((k, -1.0), (k, 0.0), (batch - 2 * k, 1.0))
        return torch.cat([card_true_llrs(c, nb, PARTIAL_EBN0[c.value] + off, seed + j)
                          for j, (nb, off) in enumerate(parts) if nb])

    for i, c in enumerate(T.ALL_CODES):
        got = hold_sp(f"{c} mixed", c, sp_mixed(c, 256, 120 + i), 20)
        if not 0 < int(got.success.sum()) < 256:
            fail(f"{c}: want a batch where some frames fail and some converge")
        print(f"    launch shape {sp_shape(c)}")
    for name in ("TM8192", "TC128"):
        c = T.get_code(name)
        got = hold_sp(f"{name} clean", c, card_true_llrs(c, 64, 100.0, 5), 20)
        if not bool(got.success.all()):
            fail(f"{name}: clean codewords must converge")
    for name in ("TM1280", "TM8192"):
        c = T.get_code(name)
        for mi in (0, 1):
            got = hold_sp(f"{name} maxiters={mi}", c, sp_mixed(c, 64, 9), mi)
            if mi == 0 and (bool(got.bits.any()) or bool(got.success.any())):
                fail(f"{name}: at maxiters=0 the bits stay 0 and nothing converges")
    for name, nb in (("TM2048", 257), ("TC256", 257), ("TM6144", 1)):
        c = T.get_code(name)
        hold_sp(f"{name} B={nb}", c, sp_mixed(c, nb, 13), 20)
    # against the CPU's plain version, which the CPU tests hold to the JAX
    # twin: PyTorch's CPU exp/log are not the card's, so the tolerance is the
    # CPU tests' (tests/test_torch_sumproduct.py): frames the CPU converges
    # decode to the same bits, iterations within 1; at most 1 other success
    c = T.get_code("TM1536")
    x = sp_mixed(c, 64, 11)
    on_card = cuda_sp.layered_sp(c, x, 20)
    on_cpu = layered_sp_plain(qc_structure(c), x.cpu(), 20)
    ok = on_cpu.success
    card = [t.cpu() for t in on_card]
    d_iter = int((card[1][ok] - on_cpu.iterations[ok]).abs().max()) if bool(ok.any()) else 0
    print(f"  TM1536 kernel on the card vs plain version on the CPU: max|diff| "
          f"{max_diff(T.MSResult(*card), on_cpu)}, on the {int(ok.sum())} frames the CPU "
          f"converges: iterations within {d_iter}")
    if not (bool(card[0][ok].all()) and torch.equal(card[2][ok], on_cpu.bits[ok]) and d_iter <= 1
            and int(card[0][~ok].sum()) <= 1):
        fail("sum-product kernel on the card is outside the CPU tests' tolerance of the CPU plain "
             "version")

    # ---- 13. the sum-product slice's path ------------------------------------------
    phase("13 sum-product slice: waterfall(device='cuda', noise_model='ebn0'), batch 8192, "
          "maxiters 100, one batch per point")

    def sp_anchor(fname, name, x, batch):
        """A stored sum-product point's frame errors, scaled to `batch` trials."""
        with open(ROOT / "benchmarks" / "results" / fname) as f:
            for row in csv.reader(f):
                if not row or row[0] != name:
                    continue
                if fname.startswith("sp_ms_gap"):  # code,surface,ebn0_db,trials,..,frame_errors,fer
                    if row[1] == "sp" and float(row[2]) == x:
                        return int(row[7]) / int(row[3]) * batch
                elif float(row[1]) == x:  # code,snr_db,trials,..,noise_model,frame_errors
                    return int(row[7]) / int(row[2]) * batch
        fail(f"{fname} has no {name} sum-product row at {x}")

    sp_launches = 0
    for impl, name, x, fname in SP_WATERFALL_POINTS:
        c = T.get_code(name)
        torch.cuda.synchronize()
        reset_launches()
        (pt,) = T.waterfall(c, [x], batch=8192, maxiters=100, max_bits=1, max_bit_errors=10**9,
                            noise_model="ebn0", impl=impl, seed=0, device="cuda")
        point_launches = dict(sumproduct_f32=cuda_sp.launches,
                              layered_minsum=cuda_layered.launches,
                              flooding_minsum=cuda_qc.launches, bitflip_u8=cuda_bf.launches)
        want = sp_anchor(fname, name, x, pt.trials)
        print(f"  {impl:10s} {name} {x} dB: {pt.csv()}  frame errors {pt.frame_errors} vs stored "
              f"{want:.0f} ({fname}); decode failures {pt.decode_failures}; mean iterations "
              f"{pt.iterations / pt.trials:.2f}; {pt.trials / pt.elapsed_s:.1f} cw/s end to end "
              f"(host clock, data made on the card); launches {point_launches}")
        if pt.trials != 8192 or not want / BAND <= pt.frame_errors <= want * BAND:
            fail(f"{impl} {name} {x} dB: {pt.frame_errors} frame errors, outside a factor {BAND} "
                 f"of the stored {want:.0f}")
        want_sp = pt.trials // 8192 if impl == "sp_layered" else 0  # one launch per batch
        if point_launches["sumproduct_f32"] != want_sp or sum(point_launches.values()) != want_sp:
            fail(f"{impl}: want {want_sp} sumproduct_f32 launches and no other kernel")
        if impl == "sp_layered":
            sp_launches = point_launches["sumproduct_f32"]
        if impl == "sp_layered" and parent is not None:
            # the parent's kernel on the same draws, in turns: parent, parent
            # (warm), this one again
            again = [fn(name, [x], batch=8192, maxiters=100, max_bits=1, max_bit_errors=10**9,
                        noise_model="ebn0", impl=impl, seed=0, device="cuda")[0]
                     for fn in (parent.waterfall, parent.waterfall, T.waterfall)]
            rates = [q.trials / q.elapsed_s for q in (pt, *again)]
            print(f"  {impl} {name} {x} dB in turns, cw/s end to end: this kernel {rates[0]:.1f}, "
                  f"parent's {rates[1]:.1f} and {rates[2]:.1f}, this kernel {rates[3]:.1f}; frame "
                  f"errors {[q.frame_errors for q in again]}")
            if any(q.frame_errors != pt.frame_errors for q in again):
                fail(f"{impl}: the parent's kernel and this one differ on the same draws")
    stage_times("sp_layered ebn0 0.9 dB", make_trial_step(code, 8192, 100, impl="sp_layered"),
                T.noise_sigma(0.9, code, "ebn0"))

    # ---- 14. the two-stage decoder ---------------------------------------------------
    phase("14 two-stage decoder (defaults): TM8192, Eb/N0 1.1 dB, batch 8192")
    g = torch.Generator(device=dev).manual_seed(140)
    data = torch.randint(0, 2, (8192, code.k), generator=g, device=dev, dtype=torch.uint8)
    sigma = T.noise_sigma(1.1, code, "ebn0")
    x = 1.0 - 2.0 * T.encode_bits(code, data).to(torch.float32) + \
        sigma * torch.randn((8192, code.n), generator=g, device=dev)
    two = T.make_two_stage_decoder(code)
    two(x[:8])  # warm
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    res = two(x)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    two_launches = {k: v for k, v in minsum_launches().items() if v}
    # the stages composed by hand on the card: bf16 layered 25, then float32
    # flooding 100 on the original LLRs of the frames the fast pass failed
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    fast = cuda_layered.layered_minsum(code, x.to(torch.bfloat16), 25)
    ev[1].record()
    bad = torch.nonzero(~fast.success.cpu()).squeeze(1).to(dev)
    resc = cuda_qc.flooding_minsum(code, x.index_select(0, bad), 100)
    ev[2].record()
    torch.cuda.synchronize()
    want = T.MSResult(
        success=fast.success.index_copy(0, bad, resc.success),
        iterations=fast.iterations.index_copy(0, bad, fast.iterations[bad] + resc.iterations),
        bits=fast.bits.index_copy(0, bad, resc.bits),
    )
    err = max_diff(res, want)
    n_bad, n_rescued = int(bad.numel()), int(resc.success.sum())
    if parent_qc is not None and n_bad:
        # the parent's flooding kernel on the same rescue batch, in turns
        rescue_x = x.index_select(0, bad)
        times = {}
        for who, fn in (("parent", parent_qc.flooding_minsum), ("this", cuda_qc.flooding_minsum),
                        ("this", cuda_qc.flooding_minsum), ("parent", parent_qc.flooding_minsum)):
            ms, out = time_ms(lambda: fn(code.value, rescue_x, 100), 1)
            times.setdefault(who, []).append(ms)
            if max_diff(out, resc) != 0:
                fail(f"the {who} flooding kernel's rescue differs from the one composed by hand")
        print(f"  rescue batch of {n_bad} frames (flooding f32, 100 iterations), CUDA events, in "
              f"turns: this kernel {times['this'][0]:.4f} / {times['this'][1]:.4f} ms, the "
              f"parent's {times['parent'][0]:.4f} / {times['parent'][1]:.4f} ms")
    wrong = int((res.success & (res.bits[:, : code.k] != data).any(dim=1)).sum())
    print(f"  fast pass (layered bf16, 25 iterations): {8192 - n_bad} of 8192 converged "
          f"({ev[0].elapsed_time(ev[1]):.4f} ms, CUDA events); rescue batch {n_bad} frames "
          f"(flooding f32, 100 iterations): {n_rescued} converged "
          f"({ev[1].elapsed_time(ev[2]):.4f} ms with the host's success-mask read); "
          f"{8192 - int(res.success.sum())} still failing; converged frames with wrong data "
          f"bits: {wrong}")
    print(f"  two-stage decode {wall * 1e3:.3f} ms (host clock); mean iterations "
          f"{res.iterations.float().mean().item():.3f}; max|diff| against the stages composed "
          f"by hand {err}; launches {two_launches}")
    if err != 0:
        fail("the two-stage decoder differs from its stages composed by hand")
    if two_launches != ({"layered_minsum_bf16": 1, "flooding_minsum_f32": 1} if n_bad
                        else {"layered_minsum_bf16": 1}):
        fail("the two-stage decoder did not run on one bf16 layered and one f32 flooding launch")
    if wrong:
        fail("a frame the two-stage decoder reports converged does not carry the data sent")
    print(f"  {smi}")

    # ---- 15. routes and sizes ---------------------------------------------------------
    phase("15 the launch table (ops/routing.py) and sizes: every code and form")
    from labrador_ldpc_tpu_torch import sizes
    from labrador_ldpc_tpu_torch.ops import routing

    t15 = time.perf_counter()
    n_checked = 0
    for c in T.ALL_CODES:
        r = routing.route_for(c)
        _, _, _, _, row_max = cuda_layered._shape(c)
        cases = []  # (impl, dtype, the route's shape, ptxas registers, the card's CTAs/SM)
        for dtype, form in forms.items():
            shape = getattr(r.layered, form)
            cases.append(("cuda_layered", dtype, shape, layered_regs[form, shape.checks_per_thread],
                          cuda_layered.card_ctas_per_sm(c, dtype)))
            cases.append(("cuda_qc", dtype, getattr(r.flooding, form), flood_regs[form, row_max],
                          cuda_qc.card_ctas_per_sm(c, dtype)))
        cases.append(("cuda_sp", torch.float32, r.sumproduct, sp_regs[row_max],
                      cuda_sp.card_ctas_per_sm(c)))
        cases.append(("cuda_bf", torch.float32, r.bitflip, bf_regs, cuda_bf.card_ctas_per_sm(c)))
        for impl, dtype, shape, regs, on_card in cases:
            want = ctas_per_sm(shape.smem_bytes, shape.threads, regs)
            mem = sizes.decoder_memory(c, impl, dtype, registers=regs)
            if want != on_card or mem.ctas_per_sm != on_card:
                fail(f"{c} {impl} {dtype}: card.ctas_per_sm gives {want} CTAs per SM at ptxas's "
                     f"{regs} registers, sizes reports {mem.ctas_per_sm}, the card's occupancy "
                     f"calculator {on_card}")
            n_checked += 1
    print(f"  {n_checked} (code, kernel, form) rows: the route's CTAs per SM at ptxas's registers "
          f"(card.ctas_per_sm) and sizes' == the card's occupancy calculator "
          f"({time.perf_counter() - t15:.2f} s)")
    print(sizes.format_memory_table())

    # ---- 16. serving -------------------------------------------------------------------
    phase("16 serving (serve.py): TM8192, B=16384, 3 flips, 4 batches in flight, 16 batches")
    from labrador_ldpc_tpu_torch.serve import serve

    reset_launches()
    rep = serve(16)
    serve_launches = cuda_layered.launches
    print(f"  {rep.frames} frames in {rep.seconds:.4f} s: {rep.frames_per_s:.1f} frames/s "
          f"sustained (host clock, pinned non-blocking copies of success flags and data bytes, "
          f"every frame checked); {rep.dispatch_s * 1e3:.4f} ms a decode dispatch "
          f"(pipelined_slope, k=32, best of 3); failures {rep.failures}, wrong frames "
          f"{rep.wrong}; launches of layered_minsum_f32 {serve_launches} (warm-up 1 + batches "
          f"{rep.batches} + slope {rep.dispatches - 1 - rep.batches}); {smi}")
    if rep.failures or rep.wrong:
        fail("a served frame failed to converge or carried other data than was sent")
    if serve_launches != rep.dispatches or cuda_layered.form_launches["f32"] != rep.dispatches:
        fail(f"serving launched layered_minsum_f32 {serve_launches} times, not once a dispatch "
             f"({rep.dispatches})")

    # ---- 17. the data-parallel waterfall on the card -----------------------------------
    phase("17 data parallelism: TM8192 waterfall, global batch 8192, one batch; NCCL one rank, "
          "Gloo two ranks on the card; every case timed after one warm run")
    import torch.distributed as dist

    from labrador_ldpc_tpu_torch.parallel import make_batch_mesh
    from labrador_ldpc_tpu_torch.parallel import mesh as pmesh
    from labrador_ldpc_tpu_torch.parallel.launch import free_port, initialize, run_processes

    def fields(pt):
        return [getattr(pt, f) for f in P17_FIELDS]

    work_dir = tempfile.TemporaryDirectory()  # (d)'s checkpoint files
    work = Path(work_dir.name)

    for kw in (P17_MS, P17_BF):
        T.waterfall(**kw, device="cuda")  # warm
    t0 = time.perf_counter()
    want_ms = fields(T.waterfall(**P17_MS, device="cuda")[0])
    one_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want_bf = fields(T.waterfall(**P17_BF, device="cuda")[0])
    one_bf_s = time.perf_counter() - t0
    want_digest = result_digest(T.decode_ms("TM8192", serving_llrs(T, dev), maxiters=50))
    print(f"  one process, no mesh: ms {dict(zip(P17_FIELDS, want_ms))} ({one_s:.3f} s); "
          f"bf bsc 0.006 {dict(zip(P17_FIELDS, want_bf))} ({one_bf_s:.3f} s)")
    want_ckpt = fields(T.waterfall(**P17_CKPT, device="cuda")[0])
    inputs, decoders = p17_inputs(T, dev), p17_decoders(T)
    want_split = {case: result_digest(decoders[case](inputs[case])) for case, _, _ in P17_SPLIT}
    del inputs, decoders
    print(f"  one process, no mesh: ms three batches {dict(zip(P17_FIELDS, want_ckpt))}")

    def hold_ckpt(who, c):
        """(d)'s checks of one rank's checkpoint cycle."""
        print(f"  {who} (d) checkpoint cycle, three batches: plain {c['plain_s']:.3f} s, "
              f"checkpointed {c['ckpt_s']:.3f} s, resumed from one batch {c['resumed_s']:.3f} s; "
              f"layered_minsum_f32 launches {c['launches']}; point lines' batches "
              f"{c['batches_full']} written, {c['batches_resumed']} after the resume; "
              f"the resumed open's broadcast_object {c['open_ms']:.4f} ms (one cold call), "
              f"{c['broadcast_ms']:.4f} ms (mean of 20 warm calls of the same payload)")
        if not c["plain"] == c["full"] == c["resumed"] == want_ckpt:
            fail(f"{who}: the checkpointed or resumed counters differ from the unsharded run's")
        if c["launches"] < 1:
            fail(f"{who}: the checkpointed point launched no layered kernel")
        for lines in (c["batches_full"], c["batches_resumed"]):
            if lines is not None and lines != [1, 2, 3, 3]:
                fail(f"{who}: the checkpoint's point lines are not one writer's: {lines}")

    def hold_split(who, split):
        """(e)-(g)'s checks of one rank's split decodes."""
        for case, form, label in P17_SPLIT:
            r = split[case]
            print(f"  {who} {label}: {r['s']:.3f} s, {form} launches {r['launches']}")
            if r["digest"] != want_split[case]:
                fail(f"{who}: the split {label} differs from the unsharded decode")
            if r["launches"] < 1:
                fail(f"{who}: the split {label} launched no {form}")

    # (a) one rank in an NCCL process group
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")  # one host: the loopback suffices
    initialize(f"127.0.0.1:{free_port()}", 1, 0, device="cuda")
    try:
        mesh = make_batch_mesh(device="cuda")
        T.waterfall(**P17_MS, device="cuda", mesh=mesh)  # warm: NCCL's communicator
        torch.cuda.synchronize()
        reset_launches()
        pmesh.collective_calls["all_reduce"] = pmesh.collective_bytes["all_reduce"] = 0
        t0 = time.perf_counter()
        got = fields(T.waterfall(**P17_MS, device="cuda", mesh=mesh)[0])
        torch.cuda.synchronize()
        nccl_s = time.perf_counter() - t0
        nccl_launches = cuda_layered.launches
        nccl_reduces = (pmesh.collective_calls["all_reduce"], pmesh.collective_bytes["all_reduce"])
        nccl_ar_ms = allreduce_ms(mesh)
        nccl_ckpt = checkpoint_cycle(T, mesh, work / "p17_nccl.jsonl")
        nccl_split = split_cases(T, mesh)
    finally:
        dist.destroy_process_group()
    print(f"  (a) NCCL, 1 rank ({mesh.backend}, {mesh.device}): {dict(zip(P17_FIELDS, got))} "
          f"in {nccl_s:.3f} s; layered_minsum_f32 launches {nccl_launches}; all_reduce of the "
          f"counters {nccl_ar_ms:.4f} ms; mesh.collective_calls all_reduce {nccl_reduces[0]} "
          f"({nccl_reduces[1]} bytes) for {got[0] // P17_MS['batch']} batches drained")
    if got != want_ms:
        fail("the NCCL one-rank waterfall's counters differ from the unsharded run's")
    if nccl_reduces != (got[0] // P17_MS["batch"], got[0] // P17_MS["batch"] * 5 * 4):
        fail(f"the NCCL one-rank waterfall counted {nccl_reduces} all_reduce calls and bytes, "
             "not one of the five int32 counters a batch drained")
    if nccl_launches < 1:
        fail("the NCCL one-rank waterfall did not launch the layered kernel")
    hold_ckpt("NCCL rank 0", nccl_ckpt)
    hold_split("NCCL rank 0", nccl_split)
    # (b), (c): two ranks on the card over Gloo
    port = free_port()
    t0 = time.perf_counter()
    try:
        outs = run_processes(
            [[sys.executable, str(Path(__file__).resolve()), "--rank", str(r), "--world", "2",
              "--port", str(port), "--work", str(work)] for r in (0, 1)], timeout=300)
    except RuntimeError as e:
        fail(f"a phase 17 rank failed: {e}")
    ranks = []
    for r, out in enumerate(outs):
        line = [x for x in out.splitlines() if x.startswith("RANK ")]
        if len(line) != 1:
            fail(f"phase 17 rank {r} printed no result:\n{out[-2000:]}")
        ranks.append(json.loads(line[0][5:]))
    gloo_s = time.perf_counter() - t0
    for r in ranks:
        print(f"  rank {r['rank']} of {r['world']} ({r['backend']}, {r['device']}): (b) ms "
              f"{dict(zip(P17_FIELDS, r['ms']['point']))} in {r['ms']['s']:.3f} s, "
              f"layered_minsum_f32 launches {r['ms']['launches']}; (c) bf "
              f"{dict(zip(P17_FIELDS, r['bf']['point']))} in {r['bf']['s']:.3f} s, bitflip_u8 "
              f"launches {r['bf']['launches']}; sharded decoder on phase 5's first batch "
              f"({r['decoder']['frames']} frames) in {r['decoder']['s']:.3f} s, launches "
              f"{r['decoder']['launches']}; all_reduce of the counters {r['allreduce_ms']:.4f} ms; "
              f"mesh.collective_calls all_reduce ms {r['ms']['all_reduce']}, bf "
              f"{r['bf']['all_reduce']} for {r['ms']['batches']} and {r['bf']['batches']} batches")
        if r["ms"]["point"] != want_ms or r["bf"]["point"] != want_bf:
            fail(f"rank {r['rank']}: the two-rank counters differ from the unsharded run's")
        if r["decoder"]["digest"] != want_digest:
            fail(f"rank {r['rank']}: the sharded decoder differs from the unsharded decode in "
                 "bits, success or iterations")
        if min(r["ms"]["launches"], r["bf"]["launches"], r["decoder"]["launches"]) < 1:
            fail(f"rank {r['rank']} launched no kernel in a phase 17 case")
        if any(r[key]["all_reduce"] != r[key]["batches"] for key in ("ms", "bf")):
            fail(f"rank {r['rank']} counted another number of all_reduce calls than batches "
                 "drained")
        hold_ckpt(f"Gloo rank {r['rank']}", r["ckpt"])
        hold_split(f"Gloo rank {r['rank']}", r["split"])
    print(f"  two Gloo ranks: counters == the unsharded run's, the sharded decode == the "
          f"unsharded one, the checkpoint cycle and the split decodes held; {gloo_s:.3f} s "
          f"with the ranks' start; {smi}")
    work_dir.cleanup()

    # ---- 18. the measurement entry points ---------------------------------------------
    phase("18 measurement entry points: bench (B=16384), bench_suite (--strict), "
          "profile_decode (cuda_layered f32, B=16384)")
    from labrador_ldpc_tpu_torch import bench, bench_suite, profile_decode

    # the entry points' launches are their own: the kernels line keeps the
    # counts of the runs above, and the counters start and end phase 18 at 0
    reset_launches()
    t18 = time.perf_counter()
    t0 = time.perf_counter()
    headline = bench.measure(device="cuda")
    diag = headline.diagnostics()
    print(f"  (a) bench: {json.dumps(headline.line)}")
    print(f"      fit: R^2 {diag['r_squared']}, points (decodes, s) {diag['fit_points']}, "
          f"residuals {diag['residuals_s']} s, {headline.fit.slope * 1e3:.4f} ms a decode, "
          f"amortized {diag['amortized_rate_cw_s']} cw/s; {time.perf_counter() - t0:.2f} s; {smi}")
    if not headline.fit.slope > 0 or cuda_layered.form_launches["f32"] < 1:
        fail("bench: no positive slope, or the layered f32 kernel was not launched")
    t0 = time.perf_counter()
    suite_argv = ["--codes", "TC128,TM8192", "--impls", "cuda_layered:float32,cuda_qc:int8",
                  "--pipeline", "8", "--reps", "1", "--strict"]
    with tempfile.TemporaryDirectory() as tmp:
        suite_out = Path(tmp) / "bench_suite.jsonl"
        rc = bench_suite.main([*suite_argv, "--out", str(suite_out)])
        suite_rows = [json.loads(line) for line in suite_out.read_text().splitlines()]
    print(f"  (b) bench_suite {' '.join(suite_argv)}: exit {rc}, {len(suite_rows)} rows in "
          f"{time.perf_counter() - t0:.2f} s")
    if rc != 0:
        fail(f"bench_suite --strict exited {rc}")
    suite_have = {(r["bench"], r["code"]) for r in suite_rows}
    suite_want = {(b, c) for c in ("TC128", "TM8192") for b in (
        "encode", "decode_bf[cuda]", "bf_iter[cuda]", "decode_ms[cuda_layered,float32]",
        "decode_ms[cuda_qc,int8]", "ms_iter[cuda_layered,float32]")} | {("decode_sp[cuda]",
                                                                           "TM8192")}
    if suite_want - suite_have:
        fail(f"bench_suite recorded no row for {sorted(suite_want - suite_have)}")
    t0 = time.perf_counter()
    try:
        busy = profile_decode.profile_decode("TM8192", "cuda_layered", torch.float32, 16384,
                                             reps=3, top=10)
        print(profile_decode.format_profile(
            busy, f"(c) profile_decode TM8192 cuda_layered float32 B=16384 maxiters=50, 3 "
                  f"decodes each waited for, on {smi}"))
    except profile_decode.NoDeviceActivity as e:
        print(f"  (c) profile_decode: torch.profiler saw no device time on this machine: {e}")
    print(f"  (c) {time.perf_counter() - t0:.2f} s")
    launched = {name: kernel_launches(name) for name in (
        "layered_minsum_f32", "layered_minsum_i8", "flooding_minsum_i8", "bitflip_u8",
        "sumproduct_f32")}
    print(f"  phase 18: {time.perf_counter() - t18:.2f} s; its own launches {launched} (not in "
          "the kernels line)")
    reset_launches()

    # ---- 19. the quality tools ------------------------------------------------
    phase("19 the quality tools: the generators' reduced cases, held to the TPU's tables by "
          "tools.compare")
    quality_tools(smi)

    def entry(name, replaces, also, launches, row, max_abs_err):
        kind = name.split("_")[0]
        source = {"layered": "layered_minsum.cu", "flooding": "flooding_minsum.cu",
                  "bitflip": "bitflip.cu", "sumproduct": "sumproduct.cu",
                  "encoder": "encoder.cu"}[kind]
        out = {
            "name": name, "route": "cuda",
            "source": f"labrador_ldpc_tpu_torch/csrc/{source}",
            # the JAX package left the encoder's product to XLA: no Pallas kernel
            "replaces": None if replaces is None else f"labrador_ldpc_tpu/ops/{replaces}",
            "also_replaces": f"labrador_ldpc_tpu/ops/{also}",
            "launches": launches, "max_abs_err": max_abs_err,
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row.get("library_ms"),
        }
        if "parent_ms" in row:
            out["parent_ms"] = row["parent_ms"]
        if also is None:
            del out["also_replaces"]
        return out

    layered_tpu = ("pallas_qc.py:728", "pallas_tc.py:268")
    flooding_tpu = ("pallas_qc.py:265", "pallas_tc.py:506")
    table = [entry("layered_minsum_f32", *layered_tpu, main_launches, main_row,
                   errs["layered_minsum_f32"])]
    for name in ("layered_minsum_i8", "layered_minsum_i16", "flooding_minsum_f32",
                 "flooding_minsum_i8", "flooding_minsum_i16"):
        tpu = layered_tpu if name.startswith("layered") else flooding_tpu
        table.append(entry(name, *tpu, int_launches[name], rows[name], errs[name]))
    table.append(entry("layered_minsum_bf16", *layered_tpu, bf16_serving_launches,
                       rows["layered_minsum_bf16"], errs["layered_minsum_bf16"]))
    table.append(entry("flooding_minsum_bf16", *flooding_tpu, bf16_launches["flooding_minsum_bf16"],
                       rows["flooding_minsum_bf16"], errs["flooding_minsum_bf16"]))
    table.append(entry("bitflip_u8", "pallas_bf.py:53", "pallas_tc.py:741",
                       slice_launches["bitflip_u8"], bf_row, bf_max_err))
    table.append(entry("sumproduct_f32", "pallas_sp.py:48", None, sp_launches, sp_row, sp_max_err))
    table.append(entry("encoder_u8", None, None, slice_launches["encoder_u8"], enc_rows["TM8192"],
                       enc_max_err))
    print(f"  flooding f32 at 1.1 dB (B={B}, maxiters={maxiters}): kernel {flood_1p1['ms']:.4f} "
          f"ms, plain {flood_1p1['plain_ms']:.4f} ms, bound {flood_1p1['bound_ms']:.4f} ms "
          f"({flood_1p1['bound_by']})")
    for label, row in (("TM8192 layered f32 at 1.5 dB, B=16384", layered_1p5),
                       ("TC512 layered f32 at 1.5 dB, B=32768", layered_tc512)):
        print(f"  {label}, maxiters={maxiters}: kernel {row['ms']:.4f} ms"
              + (f", parent {row['parent_ms']:.4f} ms" if "parent_ms" in row else "")
              + f", bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card_kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
