"""The CUDA layered min-sum kernel's launch shape, addend table and state
layout, on the CPU.

`csrc/layered_minsum.cu` keeps a codeword's whole state in shared memory:
the posteriors, each edge's t', each check's (m1, m2) of its last visit and
its sign a bit in a packed word, and the posteriors' hard decisions packed
32 a word, with no per-edge u. It rebuilds the previous iteration's u of an
edge from t' and its check's stats, carries, across the barrier between its
two passes, each check's two u_old magnitudes and a bit per addend for which
one and for its sign, and forms the end-of-iteration syndrome as XORs of
32-bit windows of the packed hard decisions. The kernel runs only on the
card; here:

  * `launch_config` against the state layout and an H100's shared memory
    (the footprint table below, computed by hand from the layout), with no
    code and form holding fewer CTAs an SM than the per-edge syndrome's
    layout did (`BYTE_SIGN_CTAS`);
  * the packed addends (`addend_descriptors`) decoded in numpy against the
    block permutations, and their pass-2 barriers against the rule that two
    addends between barriers never share a block column;
  * the syndrome windows (`syndrome_windows`) in numpy against the per-edge
    parity of va < 0 on all nine codes, -0.0 and 0.0 included;
  * a replay of the kernel's algorithm in plain torch, written here and not
    taken from the package: it keeps only t', the stats (the signs packed)
    and the posteriors, recomputes u_old, forms the syndrome from the packed
    hard decisions and the windows, and must equal `layered_minsum_plain`
    bit for bit (bits, success, iterations) in every dtype form, with and
    without alpha.
"""

import math

import numpy as np
import pytest
import torch

import labrador_ldpc_tpu_torch as T
from labrador_ldpc_tpu_torch.codes.expand import qc_structure
from labrador_ldpc_tpu_torch.ops import cuda_layered
from labrador_ldpc_tpu_torch.ops.qc_minsum import layered_minsum_plain
from test_torch_layered import PARTIAL_EBN0, noisy_llrs, one_torch_thread  # noqa: F401

NAMES = [c.value for c in T.ALL_CODES]
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "i8": torch.int8, "i16": torch.int16}

# shared bytes per codeword (va + t' + m1 + m2 + packed signs, R*M/32 words
# rounded up + packed hard decisions, Cc*W words) and the CTAs an H100 SM holds at that footprint: 233,472 //
# (bytes + 1,024), at most 32, but for TM2048 int8, where four checks a
# thread (128 threads) at 64 registers hold 8
FOOTPRINT = {
    "TC128": {"f32": (3112, 32), "bf16": (1576, 32), "i8": (1192, 32), "i16": (1832, 32)},
    "TC256": {"f32": (6192, 32), "bf16": (3120, 32), "i8": (2352, 32), "i16": (3632, 32)},
    "TC512": {"f32": (12384, 17), "bf16": (6240, 32), "i8": (4704, 32), "i16": (7264, 28)},
    "TM1280": {"f32": (28896, 7), "bf16": (14560, 14), "i8": (11616, 18), "i16": (17376, 12)},
    "TM1536": {"f32": (37184, 6), "bf16": (18752, 11), "i8": (14912, 14), "i16": (22336, 9)},
    "TM2048": {"f32": (53760, 4), "bf16": (27136, 8), "i8": (21504, 8), "i16": (32256, 7)},
    "TM5120": {"f32": (115584, 2), "bf16": (58240, 3), "i8": (46464, 4), "i16": (69504, 3)},
    "TM6144": {"f32": (148736, 1), "bf16": (75008, 3), "i8": (59648, 3), "i16": (89344, 2)},
    "TM8192": {"f32": (215040, 1), "bf16": (108544, 2), "i8": (86016, 2), "i16": (129024, 1)},
}
# the CTAs an SM held with a sign byte a check and the syndrome visiting every
# edge (R*M bytes of signs, no packed hard decisions): no count may fall
BYTE_SIGN_CTAS = {
    "TC128": (32, 32, 32, 32), "TC256": (32, 32, 32, 32), "TC512": (17, 31, 32, 27),
    "TM1280": (7, 14, 18, 12), "TM1536": (6, 11, 14, 9), "TM2048": (4, 8, 8, 6),
    "TM5120": (1, 3, 4, 3), "TM6144": (1, 3, 3, 2), "TM8192": (1, 2, 2, 1),
}


@pytest.mark.parametrize("name", NAMES)
def test_launch_config(name):
    s = qc_structure(name)
    M, R, Cc = s.m, s.n_block_rows, s.n_block_cols
    sumA = sum(len(row) for row in s.rows)
    W = max(1, M // 32)  # words of a packed block row or column
    for (form, dtype), before in zip(DTYPES.items(), BYTE_SIGN_CTAS[name]):
        cfg = cuda_layered.launch_config(name, dtype)
        va_bytes = 2 if form == "bf16" else 4
        t_bytes = dtype.itemsize
        layout = (Cc * M * va_bytes + sumA * M * t_bytes + 2 * R * M * t_bytes
                  + 4 * math.ceil(R * M / 32) + 4 * Cc * W)
        assert cfg["smem_bytes"] == layout == FOOTPRINT[name][form][0], (name, form)
        assert cfg["smem_bytes"] <= 232_448
        assert cfg["ctas_per_sm"] == FOOTPRINT[name][form][1], (name, form)
        assert cfg["ctas_per_sm"] >= before, (name, form)
        assert (cfg["syndrome_words"], cfg["syndrome_windows"]) == (R * W, sumA * W)
        threads, checks = cfg["threads"], cfg["checks_per_thread"]
        assert threads % 32 == 0 and 32 <= threads <= 1024
        assert checks in (1, 2, 4)
        assert (threads, checks) == (32, 1) if M < 32 else threads * checks == M
        # the CTAs fit the 64 registers a thread of __launch_bounds__(1024)
        assert threads * cfg["ctas_per_sm"] <= 1024
    with pytest.raises(ValueError, match="float64"):
        cuda_layered.launch_config(name, torch.float64)


def _perm(lo, hi, i, m):
    """perm of the check offsets i (array) from one packed addend, as the
    kernel decodes it."""
    s0 = (lo >> 7) & 4095
    if not lo & 16:
        return (i + s0) % m
    q = m // 4
    j = i // q
    phis = np.array([s0, hi & 1023, (hi >> 10) & 1023, (hi >> 20) & 1023])
    return (((lo >> 5) & 3) + j) % 4 * q + (phis[j] + i) % q


def test_addend_descriptors():
    for name in NAMES:
        s = qc_structure(name)
        desc = cuda_layered.addend_descriptors(s)
        assert desc.shape == (sum(len(row) for row in s.rows), 2) and desc.dtype == np.int32
        i = np.arange(s.m)
        e0 = 0
        for row in s.rows:
            e1 = e0 + len(row)
            ends = [(int(lo) >> 19) & 63 for lo in desc[e0:e1, 0]]
            runs = []
            for e, p in enumerate(row, start=e0):
                lo, hi = (int(x) for x in desc[e])
                assert lo & 15 == p.col
                np.testing.assert_array_equal(_perm(lo, hi, i, s.m), p.apply(i, s.m))
                if not runs or e == ends[e - e0 - 1]:
                    runs.append([])
                runs[-1].append(p.col)
                assert e < ends[e - e0] <= e1
            # the runs tile the layer; within a run the columns are distinct
            # (pass 2 needs no barrier there), and each run but the last ends
            # where the next addend's column repeats one of the run's
            assert sum(map(len, runs)) == len(row) and ends[-1] == e1
            for run, nxt in zip(runs, runs[1:]):
                assert len(set(run)) == len(run) and nxt[0] in run
            assert len(set(runs[-1])) == len(runs[-1])
            # every TM row writes one column two or three times: more than one run
            assert len(runs) > 1
            e0 = e1


def _pack(bits, m):
    """(B, X*m) 0/1 -> (B, X*W) uint64 words holding 32 bits each, as the
    kernel's ballots pack them: bit l of word w is bit 32*w + l, and for
    m = 16 (W = 1) a block's 16 bits twice in one word."""
    bits = np.asarray(bits, dtype=np.uint64)
    B = bits.shape[0]
    if m == 16:
        bits = np.tile(bits.reshape(B, -1, 16), 2)
    return (bits.reshape(B, -1, 32) << np.arange(32, dtype=np.uint64)).sum(-1, dtype=np.uint64)


def _syndrome(s, win, hard):
    """The kernel's check words from the packed hard decisions (B, V) 0/1 and
    the window table: word j of row r is the XOR of the row's windows j, a
    window the funnel shift of words w0 and w1 right by b."""
    W = win.shape[1]
    words = _pack(hard, s.m)
    ent = win.astype(np.int64)
    b = (ent & 31).astype(np.uint64)
    lo, hi = words[:, (ent >> 5) & 0x1FFF], words[:, ent >> 18]
    windows = ((hi << np.uint64(32) | lo) >> b) & np.uint64(0xFFFFFFFF)  # (B, sumA, W)
    out, e0 = [], 0
    for row in s.rows:
        out.append(np.bitwise_xor.reduce(windows[:, e0:e0 + len(row)], axis=1))
        e0 += len(row)
    return np.concatenate(out, axis=1).reshape(hard.shape[0], len(s.rows) * W)


def test_syndrome_windows_equal_edge_parity():
    """On all nine codes, the check words formed from the packed hard
    decisions and `syndrome_windows` equal the per-edge parity of va < 0,
    packed the same way; -0.0 counts as 0 and so does 0.0."""
    rng = np.random.default_rng(5)
    for name in NAMES:
        s = qc_structure(name)
        M, V = s.m, s.n_block_cols * s.m
        win = cuda_layered.syndrome_windows(s)
        assert win.shape == (sum(map(len, s.rows)), max(1, M // 32)) and win.dtype == np.int32
        va = rng.standard_normal((6, V)).astype(np.float32)
        va[0] = np.abs(va[0])  # every check satisfied
        va[1, rng.integers(0, V, V // 3)] = -0.0
        va[2, rng.integers(0, V, V // 3)] = 0.0
        va[3, : V // 2] = -0.0
        hard = va < 0
        i = np.arange(M)
        parity = np.concatenate([
            np.bitwise_xor.reduce([hard[:, p.col * M + p.apply(i, M)] for p in row], axis=0)
            for row in s.rows], axis=1)
        got = _syndrome(s, win, hard)
        np.testing.assert_array_equal(got, _pack(parity, M), err_msg=name)
        assert not got[0].any() and got[4:].any(axis=1).all(), name


def _replay(name, llrs, maxiters, alpha=None):
    """The kernel's algorithm: t' per edge, (m1, m2) per check and its sign a
    bit of a packed word, u_old rebuilt from them; pass 2 rebuilds u_old
    again from the two magnitudes and the per-addend bits that pass 1
    recorded; the syndrome from the packed hard decisions and the windows."""
    s = qc_structure(name)
    M, Cc = s.m, s.n_block_cols
    win = cuda_layered.syndrome_windows(s)
    check = torch.arange(M)

    # check c = r*M + i keeps its sign at bit c mod 32 of word c / 32 (a row of
    # TC128 takes half a word, and its writes keep the other row's half)
    def put_signs(words, r, sg):
        c = r * M + check
        for w in torch.unique(c // 32).tolist():
            sel = c // 32 == w
            bit = c[sel] % 32
            mask = int((1 << bit).sum())
            val = (sg[:, sel].to(torch.int64) << bit).sum(dim=1)
            words[:, w] = (words[:, w] & ~mask) | val

    def sign_bits(words, r):
        c = r * M + check
        return ((words[:, c // 32] >> (c % 32)) & 1).bool()

    B = llrs.shape[0]
    dtype = llrs.dtype
    desc = cuda_layered.addend_descriptors(s)
    perms = [torch.from_numpy(_perm(int(lo), int(hi), np.arange(M), M)) for lo, hi in desc]
    cols = [int(lo) & 15 for lo, _ in desc]
    is_int = dtype in (torch.int8, torch.int16)
    if is_int:
        lo_, hi_ = torch.iinfo(dtype).min, torch.iinfo(dtype).max
        cdt, big = torch.int32, hi_
    else:
        cdt, big = torch.float32, torch.finfo(torch.float32).max

    def st(x):  # a value as stored in T and read back
        return x.to(torch.bfloat16).to(cdt) if dtype == torch.bfloat16 else x

    def sat(x):
        return x.clamp(lo_, hi_) if is_int else x

    def sat_abs(x):
        return x.abs().clamp(max=hi_) if is_int else st(x).abs()

    def scale(m):
        return m if alpha is None else torch.tensor(alpha, dtype=torch.float32) * m

    va = torch.zeros((B, Cc * M), dtype=cdt)
    va[:, : llrs.shape[1]] = llrs.to(cdt)
    sumA = len(desc)
    tp = torch.zeros((sumA, B, M), dtype=cdt)
    m1s = torch.zeros((s.n_block_rows, B, M), dtype=cdt)
    m2s = torch.zeros_like(m1s)
    sgw = torch.zeros((B, -(-s.n_block_rows * M // 32)), dtype=torch.int64)
    done = torch.zeros(B, dtype=torch.bool)
    iters = torch.full((B,), maxiters, dtype=torch.int32)
    bits = torch.zeros((B, Cc * M), dtype=torch.uint8)
    zero = torch.zeros((), dtype=cdt)
    e0 = 0
    for it in range(maxiters):
        first = it == 0
        e0 = 0
        for r, row in enumerate(s.rows):
            es = range(e0, e0 + len(row))
            e0 += len(row)
            # pass 1
            if not first:
                m1o, sgo = m1s[r].clone(), sign_bits(sgw, r)
                u1, u2 = st(scale(m1o)), st(scale(m2s[r].clone()))
            m1 = torch.full((B, M), big, dtype=cdt)
            m2 = m1.clone()
            sg = torch.zeros((B, M), dtype=torch.bool)
            which, flips = {}, {}
            for e in es:
                g = va[:, cols[e] * M + perms[e]]
                if first:
                    u_old = tpe = zero
                else:
                    tpe = tp[e]
                    which[e] = sat_abs(tpe) == m1o
                    flips[e] = sgo ^ (tpe < 0)
                    mag = torch.where(which[e], u2, u1)
                    u_old = torch.where(flips[e], -mag, mag)
                t = sat(g - u_old)
                t = torch.where(((t < 0) == (tpe < 0)) | (tpe == 0), t, zero)
                tp[e] = st(t)
                a1 = sat_abs(t)
                m2 = torch.where(a1 < m1, m1, torch.minimum(m2, a1))
                m1 = torch.minimum(m1, a1)
                sg = sg ^ (t < 0)
            m1s[r], m2s[r] = st(m1), st(m2)
            put_signs(sgw, r, sg)
            # pass 2
            sgn = sign_bits(sgw, r)
            for e in es:
                t = tp[e]
                mag = scale(torch.where(sat_abs(t) == m1s[r], m2s[r], m1s[r]))
                u = torch.where(sgn ^ (t < 0), -mag, mag)
                if first:
                    u_old = zero
                else:
                    um = torch.where(which[e], u2, u1)
                    u_old = torch.where(flips[e], -um, um)
                idx = cols[e] * M + perms[e]
                va[:, idx] = st(va[:, idx] + st(u - u_old))  # int: wide, never clipped
        bad = torch.from_numpy(_syndrome(s, win, (va < 0).numpy()).any(axis=1))
        new = ~bad & ~done
        bits = torch.where(done[:, None], bits, (va < 0).to(torch.uint8))
        iters = torch.where(new, torch.full_like(iters, it), iters)
        done = done | ~bad
        if bool(done.all()):
            break
    return T.MSResult(success=done, iterations=iters, bits=bits)


def _llrs(name, dtype, batch, seed):
    """Noisy LLRs, half of them 1 dB below the code's partial-convergence
    point (most fail) and half 2 dB above it (most converge within a few
    iterations); int forms quantized, with the last eighth of the rows
    uniform over the int range."""
    x = torch.from_numpy(np.concatenate([
        noisy_llrs(name, batch // 2, PARTIAL_EBN0[name] - 1.0, seed),
        noisy_llrs(name, batch - batch // 2, PARTIAL_EBN0[name] + 2.0, seed + 1)]))
    if dtype not in (torch.int8, torch.int16):
        return x.to(dtype)
    q = T.quantize_llrs(x, dtype)
    info = torch.iinfo(dtype)
    rng = np.random.default_rng(seed)
    rows = batch // 8
    q[-rows:] = torch.from_numpy(rng.integers(info.min, info.max + 1, (rows, q.shape[1]))).to(dtype)
    return q


@pytest.mark.parametrize("form", list(DTYPES))
@pytest.mark.parametrize("name,batch", [("TM2048", 24), ("TC128", 64)])
def test_recompute_replay_matches_plain(name, batch, form):
    dtype = DTYPES[form]
    s = qc_structure(name)
    llrs = _llrs(name, dtype, batch, seed=7)
    alphas = (None,) if dtype in (torch.int8, torch.int16) else (None, 0.8)
    for alpha in alphas:
        for maxiters in (0, 1, 5):
            got = _replay(name, llrs, maxiters, alpha)
            want = layered_minsum_plain(s, llrs, maxiters, alpha)
            for g, w in zip(got, want):
                assert torch.equal(g, w), (name, form, alpha, maxiters)
    # the batch exercises both outcomes at maxiters 5
    assert 0 < int(want.success.sum()) < batch
