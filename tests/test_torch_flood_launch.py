"""The CUDA flooding min-sum kernel's launch shape, sweep-1 schedule and
algorithm, on the CPU.

`csrc/flooding_minsum.cu` keeps a codeword's posteriors, LLRs and each
edge's variable index in shared memory and nothing else there: each check
has one owner thread for the whole decode, which holds the check's m1, m2 and
one packed word in registers (its sign product, its argmin and, per addend,
the sign and the zero test of the stored v) instead of a per-edge v plane;
sweep 1 is the owners' scatter in runs, run k holding the k-th addend of
every block column, with a barrier only between runs. The kernel runs only
on the card; here:

  * `launch_config` against the state layout and an H100's limits, for all
    nine codes and four forms;
  * the run cut: as many runs as the largest column degree, every column's
    addends in addend order, and the packed run words of sweep 1's order;
  * the identity that lets the kernel drop the v plane: "|v| == m1" and
    "this addend is the check's argmin" pick the same magnitude, ties and
    saturated int8 values included;
  * a replay of the kernel's schedule in plain torch, written here and not
    taken from the package (only the per-dtype arithmetic, `_Arith`, which
    the JAX-twin tests pin, is shared): per-check state in owner order, no v
    plane, each edge's variable unpacked once from the addend descriptors,
    sweep 1 taken in the run words' order and applied run by run to the
    posteriors as the run found them, the first run reading the LLRs. It
    must equal
    `flooding_minsum_plain` bit for bit (bits, success, iterations).
"""

import numpy as np
import pytest
import torch

import labrador_ldpc_tpu_torch as T
from labrador_ldpc_tpu_torch.codes.expand import qc_structure
from labrador_ldpc_tpu_torch.ops import cuda_qc
from labrador_ldpc_tpu_torch.ops.cuda_layered import addend_descriptors, addend_table
from labrador_ldpc_tpu_torch.ops.qc_minsum import _Arith, flooding_minsum_plain
from test_torch_layered import PARTIAL_EBN0, noisy_llrs, one_torch_thread  # noqa: F401
from test_torch_layered_launch import _perm

NAMES = [c.value for c in T.ALL_CODES]
DTYPES = (torch.float32, torch.bfloat16, torch.int8, torch.int16)

# threads, checks a thread, sweep-1 runs; the widest row and its column
# degrees (the greedy cut of the addend order into runs on distinct columns
# would take the widest row's count, or 7 at TM2048/TM8192)
SHAPE = {
    "TC128": (32, 1, 5), "TC256": (32, 1, 5), "TC512": (64, 1, 5),
    "TM1280": (128, 1, 6), "TM5120": (512, 1, 6),
    "TM1536": (256, 1, 6), "TM6144": (1024, 1, 6),
    "TM2048": (256, 2, 6), "TM8192": (1024, 2, 6),
}


@pytest.mark.parametrize("name", NAMES)
def test_launch_config(name):
    s = qc_structure(name)
    M, Cc = s.m, s.n_block_cols
    width = max(len(row) for row in s.rows)
    sumA = sum(len(row) for row in s.rows)
    for dt in DTYPES:
        cfg = cuda_qc.launch_config(name, dt)
        threads, checks = cfg["threads"], cfg["checks_per_thread"]
        assert (threads, checks, cfg["runs"]) == SHAPE[name]
        assert cuda_qc.INSTANCES[width] == checks
        assert cfg["barriers_per_iteration"] == cfg["runs"] + 1
        # va and the LLRs, two planes of Cc*M values of the LLRs' type, and
        # each edge's variable in 16 bits
        size = torch.empty((), dtype=dt).element_size()
        assert cfg["smem_bytes"] == 2 * Cc * M * size + 2 * sumA * M < 232_448
        assert threads % 32 == 0 and 32 <= threads <= 1024
        assert (threads, checks) == (32, 1) if M < 32 else threads * checks == M
        # 1,024 threads an SM at the 64 registers a thread of
        # __launch_bounds__(1024), in every code and form
        assert threads * cfg["ctas_per_sm"] == 1024
    if name == "TM8192":
        assert cuda_qc.launch_config(name)["smem_bytes"] == 143_360
    with pytest.raises(ValueError, match="takes"):
        cuda_qc.launch_config(name, torch.float64)


def test_run_cut_and_run_words():
    """Each run holds a block column at most once, every column's addends
    come in addend order, and the packed run words decode to the schedule."""
    for name in NAMES:
        s = qc_structure(name)
        cols = [p.col for row in s.rows for p in row]
        order, ends = cuda_qc.flooding_schedule(s)
        sumA = len(cols)
        assert sorted(order) == list(range(sumA)) and ends[-1] == sumA
        assert len(ends) == max(np.bincount(cols)) == SHAPE[name][2]
        starts = [0, *ends[:-1]]
        for a, b in zip(starts, ends):
            run = [cols[e] for e in order[a:b]]
            assert len(set(run)) == len(run)
        for c in set(cols):
            mine = [e for e in order if cols[e] == c]
            assert mine == sorted(mine)
        words = cuda_qc.flooding_runs(s)
        assert words.shape == (sumA,) and words.dtype == np.int32
        _, off = addend_table(s)
        for k, e in enumerate(order):
            w = int(words[k])
            row, pos = (w >> 6) & 3, (w >> 8) & 31
            assert w & 63 == e == int(off[row]) + pos and pos < len(s.rows[row])
            assert (w >> 13) & 63 == next(x for x in ends if x > k)


def test_argmin_picks_the_magnitude_of_the_v_test():
    """Rows of self-corrected v: the twin's u magnitude (m2 where |v| == m1,
    else m1) equals the kernel's (m2 for the check's argmin, the first
    addend at sat_abs(v) == m1, else m1), with ties and int8 -128 common, in
    float32, bfloat16 (whose rounding makes more ties) and int8."""
    rng = np.random.default_rng(3)
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        ar = _Arith(dtype, torch.device("cpu"))
        if dtype == torch.int8:
            nv = torch.from_numpy(rng.choice([-128, -127, -3, -1, 0, 1, 3, 127], (4096, 6)))
            nv = nv.to(torch.int32)
        else:
            nv = torch.from_numpy(rng.choice([-2.0, -1.0, -1.001, 0.0, 1.0, 1.004, 3.0],
                                             (4096, 6))).to(torch.float32)
        m1 = torch.full((4096,), ar.big, dtype=ar.cdt)
        m2, arg = m1.clone(), torch.zeros(4096, dtype=torch.int64)
        for j in range(6):
            a1 = ar.sat_abs(nv[:, j])
            arg = torch.where(a1 < m1, j, arg)
            m2 = torch.where(a1 < m1, m1, torch.minimum(m2, a1))
            m1 = torch.minimum(m1, a1)
        v = ar.store(nv)  # the stored v the twin compares
        for j in range(6):
            twin = torch.where(v[:, j].abs() == m1, m2, m1)
            kernel = torch.where(arg == j, m2, m1)
            assert torch.equal(twin, kernel), (dtype, j)
        assert int((m1 == m2).sum()) > 100  # ties did occur


def _owners(M, threads, K):
    """The checks the kernel's threads own: thread t owns t + threads*k;
    lanes past M of a one-warp CTA (M < 32) shadow a check and are left out."""
    i = (np.arange(threads)[None, :] + threads * np.arange(K)[:, None]).ravel()
    return i[:M] if M < 32 else i


def _u(ar, m1, m2, word, j):
    """Addend j's u from a check's (m1, m2, word), as the kernel's u_msg."""
    mag = torch.where(((word >> 1) & 31) == j, m2, m1)
    if ar.alpha is not None:
        mag = ar.scale(mag)
    return torch.where((word & 1) != ((word >> (6 + 2 * j)) & 1), -mag, mag)


def _replay(name, llrs, maxiters, alpha=None):
    """The kernel's schedule. Per-check tensors are (B, M) in owner order:
    slot s holds check idx[s]; a check's state is (m1, m2, word), the word
    an int64 laid out as the kernel's."""
    s = qc_structure(name)
    M, R, Cc = s.m, s.n_block_rows, s.n_block_cols
    cfg = cuda_qc.launch_config(name, llrs.dtype)
    idx = _owners(M, cfg["threads"], cfg["checks_per_thread"])
    desc = addend_descriptors(s)
    words = cuda_qc.flooding_runs(s)
    sumA = len(desc)
    _, off = addend_table(s)
    # each edge's variable, unpacked once from the descriptors
    vix = [(int(lo) & 15) * M + _perm(int(lo), int(hi), idx, M) for lo, hi in desc]
    ar = _Arith(llrs.dtype, torch.device("cpu"), alpha)
    B = llrs.shape[0]
    sl = torch.zeros((B, Cc * M), dtype=ar.cdt)
    sl[:, : llrs.shape[1]] = llrs.to(ar.cdt)
    va = torch.zeros_like(sl)
    zero_bits = sum(1 << (7 + 2 * j) for j in range(max(len(row) for row in s.rows)))
    m1 = [torch.zeros((B, M), dtype=ar.cdt) for _ in range(R)]
    m2 = [torch.zeros((B, M), dtype=ar.cdt) for _ in range(R)]
    word = [torch.full((B, M), zero_bits, dtype=torch.int64) for _ in range(R)]
    done = torch.zeros(B, dtype=torch.bool)
    iters = torch.full((B,), maxiters, dtype=torch.int32)
    bits = torch.zeros((B, Cc * M), dtype=torch.uint8)
    for it in range(maxiters):
        e, run = 0, 0
        while e < sumA:  # sweep 1, a run at a time
            end = (int(words[e]) >> 13) & 63
            start = (sl if run == 0 else va).clone()
            for k in range(e, end):
                w = int(words[k])
                r, j, v = (w >> 6) & 3, (w >> 8) & 31, vix[w & 63]
                va[:, v] = ar.sat(ar.post(start[:, v], _u(ar, m1[r], m2[r], word[r], j)))
            e, run = end, run + 1
        bad = torch.zeros(B, dtype=torch.bool)
        for r in range(R):  # sweep 2
            n1 = torch.full((B, M), ar.big, dtype=ar.cdt)
            n2 = n1.clone()
            nw = torch.zeros((B, M), dtype=torch.int64)
            arg = torch.zeros((B, M), dtype=torch.int64)
            par = torch.zeros((B, M), dtype=torch.bool)
            for j in range(int(off[r + 1] - off[r])):
                g = va[:, vix[int(off[r]) + j]]
                nv = ar.sat(g - _u(ar, m1[r], m2[r], word[r], j))
                neg_old = ((word[r] >> (6 + 2 * j)) & 1).bool()
                zero_old = ((word[r] >> (7 + 2 * j)) & 1).bool()
                nv = torch.where(((nv < 0) == neg_old) | zero_old, nv, ar.zero)
                par ^= g < 0
                a1 = ar.sat_abs(nv)
                arg = torch.where(a1 < n1, j, arg)
                n2 = torch.where(a1 < n1, n1, torch.minimum(n2, a1))
                n1 = torch.minimum(n1, a1)
                sv = ar.store(nv)
                nw ^= (nv < 0).to(torch.int64)
                nw |= (sv < 0).to(torch.int64) << (6 + 2 * j) | (sv == 0).to(torch.int64) << (7 + 2 * j)
            m1[r], m2[r], word[r] = n1, n2, nw | arg << 1
            bad |= par.any(dim=1)
        bits = torch.where(done[:, None], bits, (va < 0).to(torch.uint8))
        iters = torch.where(~bad & ~done, torch.full_like(iters, it), iters)
        done |= ~bad
        if bool(done.all()):
            break
    return T.MSResult(success=done, iterations=iters, bits=bits)


def _inputs(name, dtype, seed):
    """24 codewords: 8 near the code's partial-convergence point, 8 at +1 dB,
    and 8 that stress the int forms: hard +-1 LLRs (ties in every check) and
    full-range values (int8 -128, int16 -32768); the float forms get the
    hard rows as they are."""
    code = T.get_code(name)
    f = torch.from_numpy(np.concatenate([
        noisy_llrs(name, 8, PARTIAL_EBN0[name], seed),
        noisy_llrs(name, 8, PARTIAL_EBN0[name] + 1.0, seed + 1)]))
    hard = torch.from_numpy(np.sign(noisy_llrs(name, 8, PARTIAL_EBN0[name] + 0.5, seed + 2)))
    if dtype in (torch.float32, torch.bfloat16):
        return torch.cat([f, hard]).to(dtype)
    info = torch.iinfo(dtype)
    g = torch.Generator().manual_seed(seed)
    full = torch.randint(info.min, info.max + 1, (4, code.n), generator=g).to(dtype)
    return torch.cat([T.quantize_llrs(f, dtype), hard[:4].to(dtype), full])


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16", "i8", "i16"])
@pytest.mark.parametrize("name", ["TC128", "TM1280", "TM8192"])
def test_schedule_replay_matches_plain(name, dtype):
    """bf16 with alpha 0.8 (the float32 alpha of the kernel and of the plain
    version); maxiters 0, 1 and 20."""
    llrs = _inputs(name, dtype, 40 + NAMES.index(name))
    alpha = 0.8 if dtype == torch.bfloat16 else None
    s = qc_structure(name)
    for maxiters in (0, 1, 20):
        got = _replay(name, llrs, maxiters, alpha)
        want = flooding_minsum_plain(s, llrs, maxiters, alpha)
        for g, w in zip(got, want):
            assert torch.equal(g, w), (name, dtype, maxiters)
    # the batch exercises both outcomes at maxiters 20
    assert 0 < int(want.success.sum()) < llrs.shape[0]
