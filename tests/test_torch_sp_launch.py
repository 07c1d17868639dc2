"""The CUDA layered sum-product kernel's launch shape, barrier schedule and
algorithm, on the CPU.

`csrc/sumproduct.cu` keeps a codeword's posteriors and every edge's u in
shared memory, and nothing else there: each thread owns K checks of every
layer for the whole decode, holds the layer's phi values, their sum and u's
signs (a bit mask) in registers across the barrier between its two passes,
and synchronises in pass 2 only between runs of addends on distinct block
columns. The kernel runs only on the card; here:

  * `launch_config` against the state layout, the kernel's instances and an
    H100's limits (the footprint table below, computed by hand: (Cc + sumA)
    * M * 4 bytes; CTAs an SM the fewest that 233,472 // (bytes + 1,024),
    the register file at 64 registers a thread, 64 warps and 32 CTAs allow);
  * the barriers per iteration that the kernel's run cut gives, against the
    one-barrier-per-addend schedule it replaced;
  * a replay of the kernel's schedule in plain torch, written here and not
    taken from the package: one owner per check (the kernel's thread map),
    phi values held per check, signs as a bit mask, pass-2 writes applied a
    run at a time to the posteriors as the run found them. It must equal
    `layered_sp_plain` bit for bit (bits, success, iterations). Every tensor
    that exp and log see is contiguous, with a size that is a multiple of
    64, so PyTorch's CPU kernels compute each element on the same vector path
    in both.
"""

import numpy as np
import pytest
import torch

import labrador_ldpc_tpu_torch as T
from labrador_ldpc_tpu_torch.codes.expand import qc_structure
from labrador_ldpc_tpu_torch.ops import cuda_sp
from labrador_ldpc_tpu_torch.ops.cuda_layered import addend_descriptors, addend_table
from labrador_ldpc_tpu_torch.ops.sumproduct import layered_sp_plain
from test_torch_layered import PARTIAL_EBN0, one_torch_thread  # noqa: F401
from test_torch_layered_launch import _perm

NAMES = [c.value for c in T.ALL_CODES]

# shared bytes per codeword (va + u), threads, checks a thread and CTAs an SM
# at 64 registers a thread
FOOTPRINT = {
    "TC128": (2560, 32, 1, 32),
    "TC256": (5120, 32, 1, 32),
    "TC512": (10240, 64, 1, 16),
    "TM1280": (25600, 128, 1, 8),
    "TM1536": (30720, 256, 1, 4),
    "TM2048": (40960, 256, 2, 4),
    "TM5120": (102400, 512, 1, 2),
    "TM6144": (122880, 1024, 1, 1),
    "TM8192": (163840, 1024, 2, 1),
}
# barriers per iteration: one after every addend of pass 2 (the kernel this
# one replaced), and after each run (the kernel), each with one after every
# layer's pass 1 and one for the syndrome
BARRIERS = {
    "TC128": (37, 13), "TC256": (37, 13), "TC512": (37, 13),
    "TM1280": (43, 24), "TM5120": (43, 24),
    "TM1536": (27, 16), "TM6144": (27, 16),
    "TM2048": (19, 12), "TM8192": (19, 12),
}


@pytest.mark.parametrize("name", NAMES)
def test_launch_config(name):
    s = qc_structure(name)
    M, Cc = s.m, s.n_block_cols
    sumA = sum(len(row) for row in s.rows)
    width = max(len(row) for row in s.rows)
    cfg = cuda_sp.launch_config(name)
    threads, checks = cfg["threads"], cfg["checks_per_thread"]
    assert cuda_sp.INSTANCES[width] == checks
    assert cfg["smem_bytes"] == (Cc + sumA) * M * 4 <= 232_448
    assert (cfg["smem_bytes"], threads, checks, cfg["ctas_per_sm"]) == FOOTPRINT[name]
    assert threads % 32 == 0 and 32 <= threads <= 1024
    assert (threads, checks) == (32, 1) if M < 32 else threads * checks == M
    # the CTAs fill the 1,024 threads an SM that the 64 registers a thread of
    # __launch_bounds__(1024) allow
    assert threads * cfg["ctas_per_sm"] == 1024
    # fewer registers lift the register file's limit up to shared memory's,
    # 64 warps' or 32 CTAs': TC512 at 53 registers (1,792 a warp, 9 warps in
    # each of four sub-partitions) holds 18
    few = cuda_sp.launch_config(name, registers=32)["ctas_per_sm"]
    assert few == min(32, 233_472 // (cfg["smem_bytes"] + 1024), 64 // (threads // 32))
    if name == "TC512":
        assert cuda_sp.launch_config(name, registers=53)["ctas_per_sm"] == 18
    # every check of a layer has exactly one owner: thread t's checks are
    # 32*K*warp + lane + 32*k; below 32 checks, lanes past M own nothing
    owned = sorted(int(i) for i in _owners(M, threads, checks))
    assert owned == list(range(M))


def _kernel_barriers(desc, off):
    """__syncthreads per iteration as the kernel's control flow takes them:
    after pass 1, before addend j > 0 of pass 2 where bit j of the layer's
    run cut is set, after pass 2, and the syndrome's."""
    n = 0
    for r in range(len(off) - 1):
        e0, w = int(off[r]), int(off[r + 1] - off[r])
        cut = 0
        for e in range(e0, e0 + w):
            cut |= 1 << (((int(desc[e, 0]) >> 19) & 63) - e0)
        n += 1 + sum(1 for j in range(1, w) if cut >> j & 1) + 1
    return n + 1


@pytest.mark.parametrize("name", NAMES)
def test_run_cut_barriers(name):
    s = qc_structure(name)
    desc = addend_descriptors(s)
    _, off = addend_table(s)
    before, after = BARRIERS[name]
    assert s.n_block_rows + len(desc) + 1 == before
    assert _kernel_barriers(desc, off) == after
    # the cut keeps pass 2's writes in addend order: no two addends between
    # barriers share a block column
    for r in range(s.n_block_rows):
        e0, e1 = int(off[r]), int(off[r + 1])
        ends = {(int(desc[e, 0]) >> 19) & 63 for e in range(e0, e1)}
        starts = [e0, *sorted(ends)]
        for a, b in zip(starts, starts[1:]):
            cols = [int(desc[e, 0]) & 15 for e in range(a, b)]
            assert len(set(cols)) == len(cols)


def _owners(M, threads, K):
    """The checks the kernel's threads own (threads, K); lanes past M of a
    one-warp CTA (M < 32) shadow a check and are left out."""
    t = np.arange(threads)[:, None]
    k = np.arange(K)[None, :]
    if M < 32:
        return (t & (M - 1))[: M].ravel()
    return ((t >> 5) * 32 * K + (t & 31) + 32 * k).ravel()


def _phi(x):
    x = torch.clamp(x, 1e-6, 25.0)
    em = torch.exp(-x)
    return torch.log((1.0 + em) / (1.0 - em))


def _replay(name, llrs, maxiters):
    """The kernel's schedule. Per-check tensors are (B, M) in owner order:
    slot s holds check idx[s]. u lives per edge in that order, va per
    variable; pass 1 keeps phi, the sum, a mask of u's signs and the
    variable index of every addend per check; pass 2 takes a run at a time,
    every write of a run reading the posteriors as the run found them."""
    s = qc_structure(name)
    M, Cc = s.m, s.n_block_cols
    cfg = cuda_sp.launch_config(name)
    idx = torch.from_numpy(_owners(M, cfg["threads"], cfg["checks_per_thread"]))
    desc = addend_descriptors(s)
    _, off = addend_table(s)
    perms = [torch.from_numpy(_perm(int(lo), int(hi), idx.numpy(), M)) for lo, hi in desc]
    cols = [int(lo) & 15 for lo, _ in desc]
    ends = [(int(lo) >> 19) & 63 for lo, _ in desc]
    B = llrs.shape[0]
    va = torch.zeros((B, Cc * M), dtype=torch.float32)
    va[:, : llrs.shape[1]] = llrs
    us = torch.zeros((len(desc), B, M), dtype=torch.float32)
    done = torch.zeros(B, dtype=torch.bool)
    iters = torch.full((B,), maxiters, dtype=torch.int32)
    bits = torch.zeros((B, Cc * M), dtype=torch.uint8)
    for it in range(maxiters):
        for r in range(s.n_block_rows):
            e0, w = int(off[r]), int(off[r + 1] - off[r])
            ph, vx, cut = [], [], 0
            neg = torch.zeros((B, M), dtype=torch.int64)
            for j in range(w):  # pass 1
                e = e0 + j
                cut |= 1 << (ends[e] - e0)
                v = cols[e] * M + perms[e]
                t = va[:, v] - us[e]
                p = _phi(t.abs())
                total = p if j == 0 else total + p
                neg |= (t < 0).to(torch.int64) << j
                ph.append(p)
                vx.append(v)
            # an odd sign product inverts the mask: bit j is then u_j's sign
            neg = neg ^ -(sum((neg >> j) & 1 for j in range(w)) & 1)
            j = 0
            while j < w:  # pass 2, a run at a time
                j1 = next(x for x in range(j + 1, w + 1) if x == w or cut >> x & 1)
                start = va.clone()
                for jj in range(j, j1):
                    mag = _phi(total - ph[jj])
                    u = torch.where(((neg >> jj) & 1).bool(), -mag, mag)
                    va[:, vx[jj]] = start[:, vx[jj]] + (u - us[e0 + jj])
                    us[e0 + jj] = u
                j = j1
        bad = torch.zeros(B, dtype=torch.bool)
        for r in range(s.n_block_rows):
            par = torch.zeros((B, M), dtype=torch.bool)
            for e in range(int(off[r]), int(off[r + 1])):
                par = par ^ (va[:, cols[e] * M + perms[e]] < 0)
            bad = bad | par.any(dim=1)
        bits = torch.where(done[:, None], bits, (va < 0).to(torch.uint8))
        iters = torch.where(~bad & ~done, torch.full_like(iters, it), iters)
        done = done | ~bad
        if bool(done.all()):
            break
    return T.MSResult(success=done, iterations=iters, bits=bits)


def _true_llrs(name, batch, ebn0_db, seed):
    """float32 true LLRs 2y/sigma^2 of BPSK over AWGN at Eb/N0."""
    code = T.get_code(name)
    sigma = T.noise_sigma(ebn0_db, code, "ebn0")
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 2, (batch, code.k), dtype=np.uint8)
    cw = T.encode_bits(code, data, device="cpu").numpy()
    soft = (1.0 - 2.0 * cw + rng.normal(0.0, sigma, cw.shape)).astype(np.float32)
    return soft * np.float32(2.0 / sigma**2)


@pytest.mark.parametrize("name", ["TC128", "TM1280", "TM8192"])
def test_schedule_replay_matches_plain(name):
    """32 codewords: half 1 dB above the code's min-sum partial-convergence
    point, half 1 dB below."""
    llrs = torch.from_numpy(np.concatenate([
        _true_llrs(name, 16, PARTIAL_EBN0[name] + 1.0, 40),
        _true_llrs(name, 16, PARTIAL_EBN0[name] - 1.0, 41)]))
    s = qc_structure(name)
    for maxiters in (0, 1, 20):
        got = _replay(name, llrs, maxiters)
        want = layered_sp_plain(s, llrs, maxiters)
        for g, w in zip(got, want):
            assert torch.equal(g, w), (name, maxiters)
    # the batch exercises both outcomes at maxiters 20
    assert 0 < int(want.success.sum()) < 32
