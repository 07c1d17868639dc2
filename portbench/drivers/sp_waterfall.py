"""A code designer's belief-propagation waterfall: repeated sweeps of the
program's `channel.waterfall.waterfall` with a sum-product impl.

The sweep is `drivers/waterfall.py`'s: the traffic file's `calls`, one
`waterfall` call each, with its shared sizes (`_calls`); every call of sweep
s seeded derive(run seed, 3, s); set-up runs one batch of the first point;
the window starts whole sweeps while it is open, and
`waterfall_trials_per_s` is every trial of them over the time from the
window's start to the end of the last. The configuration gives the code,
maxiters and the impl (`sp_layered`: the program's sum-product is a
`decoder="ms"` impl on float32 true LLRs 2y/sigma^2).

The judge: `judge_points` points drawn from the seed among all the points of
the window, as `drivers/waterfall.py` draws them. The reference replays each
batch by batch from the same generators under the stopping rule
(`reference.channel.replay_point`): `batch_generator` -> `draw` -> `encode`
-> `bpsk_awgn` -> `sumproduct.true_llrs` -> `sumproduct.layered_sp`. A point
is wrong unless trials, bit errors, frame errors, decode failures and
iterations all equal the reference's.

Stderr: each judged point's counters, and for each Eb/N0 of the window its
points, trials, frame errors and mean sweeps a frame.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..harness import Check, Outcome, derive
from ..reference import channel as ref_channel
from ..reference import sumproduct as ref_sp
from ..reference.codes import code as ref_code
from .waterfall import COUNTERS, _calls, _first_batch

__all__ = ["run", "replay", "CONTROLS"]

# controls that put the reference in the program's place: (the encoder's
# product, the dtype the true LLRs are rounded through). The sum-product
# impls take float32 alone, so the program has no bfloat16 path of its own.
CONTROLS = {"bfloat16": ("float32", "bfloat16"), "encoder_tf32": ("tf32", "float32"),
            "encoder_bfloat16": ("bfloat16", "float32")}


def run(ctx, control: str | None = None) -> Outcome:
    """One run of the cell. `control`, for the control runs only: a key of
    CONTROLS, which computes every call by the reference at that precision."""
    from labrador_ldpc_tpu_torch.channel import awgn
    from labrador_ldpc_tpu_torch.channel.waterfall import waterfall

    ctx.mark("import the program")
    if control is not None and control not in CONTROLS:
        raise ValueError(f"the sum-product waterfall takes the controls {sorted(CONTROLS)}, "
                         f"not {control!r}")
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    dev, cuda = ctx.device, ctx.device.type == "cuda"
    c = ref_code(cfg["code"])
    maxiters, impl = cfg["decoder"]["maxiters"], cfg["decoder"]["impl"]
    calls = _calls(tr, c.k, ctx.dry_run)

    def call(kw: dict, seed: int):
        if control is not None:
            return _reference_call(c.name, kw, seed, maxiters, dev, *CONTROLS[control])
        return waterfall(cfg["code"], kw["snrs_db"], batch=kw["batch"], maxiters=maxiters,
                         max_bits=kw["max_bits"], max_bit_errors=kw["max_bit_errors"],
                         noise_model=kw["noise_model"], dtype_name=kw["dtype_name"],
                         impl=impl, seed=seed, decoder=kw["decoder"],
                         pipeline_depth=kw["pipeline_depth"], device=dev)

    first = calls[0]
    call(dict(first, snrs_db=first["snrs_db"][:1], max_bits=first["batch"] * c.k), 0)  # warm-up
    if cuda:
        torch.cuda.synchronize(dev)
    ctx.mark("warm-up: one batch of the first point")

    done: list = []  # (kwargs, seed, points) of every call made in the window
    n_fixed = tr["dry_run"]["sweeps"] if ctx.dry_run else None

    def sweeps(t_end: float) -> float:
        s = 0
        while (n_fixed is not None and s < n_fixed) or \
                (n_fixed is None and time.perf_counter() < t_end):
            seed = derive(ctx.seed, 3, s)
            for kw in calls:
                done.append((kw, seed, call(kw, seed)))
            s += 1
        return time.perf_counter()

    trace = None
    if ctx.trace:
        from ..trace import profiled

        encode_bits = awgn.encode_bits

        def traced_encode(*args, **kwargs):
            with torch.profiler.record_function("portbench.encode_bits"):
                return encode_bits(*args, **kwargs)

        awgn.encode_bits = traced_encode
        try:
            with profiled(dev) as holder:
                t0 = ctx.window_started()
                t_last = sweeps(t0 + ctx.seconds)
        finally:
            awgn.encode_bits = encode_bits
        trace = holder.trace
    else:
        t0 = ctx.window_started()
        t_last = sweeps(t0 + ctx.seconds)
    memory_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if cuda:
        torch.cuda.empty_cache()

    points = [(kw, seed, j, pt) for kw, seed, pts in done for j, pt in enumerate(pts)]
    trials = sum(pt.trials for *_, pt in points)
    iterations = sum(pt.iterations for *_, pt in points)
    failures = sum(pt.decode_failures for *_, pt in points)
    ctx.say(f"waterfall: {len(done)} calls, {len(points)} points, {trials} trials in "
            f"{t_last - t0:.3f} s; {failures} decode failures")
    _say_points(ctx, points)
    t_judge = time.perf_counter()
    wrong = _judge(ctx, c, points, maxiters, tr["judge_points"])
    ctx.say(f"judge: {time.perf_counter() - t_judge:.3f} s")
    # converged codewords ran iterations + 1 sweeps, failed ones maxiters
    counts = {"trials": trials, "sweeps": iterations + trials - failures,
              "dtype": calls[0]["dtype_name"]}
    checks = [Check("points_wrong", wrong, 0)]
    return Outcome(trials, wrong, {"waterfall_trials_per_s": trials / (t_last - t0)}, counts,
                   checks, memory_peak, trace)


def _say_points(ctx, points) -> None:
    """Points, trials, frame errors and mean sweeps a frame of each Eb/N0."""
    by_snr: dict = {}
    for kw, _, j, pt in points:
        agg = by_snr.setdefault(kw["snrs_db"][j], [0, 0, 0, 0])
        agg[0] += 1
        agg[1] += pt.trials
        agg[2] += pt.frame_errors
        agg[3] += pt.iterations + pt.trials - pt.decode_failures
    for snr, (n, t, fe, sw) in sorted(by_snr.items()):
        ctx.say(f"point {snr} dB: {n} points, {t} trials, {fe} frame errors (FER {fe / t:.4e}), "
                f"mean sweeps {sw / t:.3f}")


def _reference_call(name: str, kw: dict, seed: int, maxiters: int, device, product: str,
                    llr_round: str):
    """One `waterfall` call computed by the reference: its points' counters."""
    out, first = [], 0
    for snr in kw["snrs_db"]:
        pt = replay(name, kw, seed, snr, first, maxiters, device, product, llr_round)
        first += pt.trials // kw["batch"]
        out.append(pt)
    return out


def replay(name: str, kw: dict, seed: int, snr: float, first_batch: int, maxiters: int,
           device, product: str = "float32", llr_round: str = "float32"
           ) -> ref_channel.Counters:
    """The reference's counters of one point of one sum-product `waterfall`
    call; `product` and `llr_round` are the controls' lower precisions."""
    if kw["noise_model"] != "ebn0":
        raise ValueError(f"the sum-product sweep takes noise_model 'ebn0', not "
                         f"{kw['noise_model']!r}")
    c = ref_code(name)
    sigma = ref_channel.ebn0_sigma(snr, c.k / c.n)

    def batch_counters(index: int) -> ref_channel.Counters:
        gen = ref_channel.batch_generator(seed, index, device)
        data, raw = ref_channel.draw(gen, kw["batch"], c.k, c.n, "normal", sigma, device)
        cw = ref_channel.encode(name, data, product)
        llrs = ref_sp.true_llrs(ref_channel.bpsk_awgn(cw, raw, sigma), sigma)
        if llr_round != "float32":
            llrs = llrs.to(getattr(torch, llr_round)).to(torch.float32)
        res = ref_sp.layered_sp(c, llrs, maxiters)
        err = (res.bits[:, :c.k] != data).sum(dim=1)
        return ref_channel.Counters(data.shape[0], int(err.sum()), int((err > 0).sum()),
                                    int((~res.success).sum()), int(res.iterations.sum()))

    counters, _ = ref_channel.replay_point(batch_counters, first_batch, kw["batch"], c.k,
                                           kw["max_bits"], kw["max_bit_errors"],
                                           kw["pipeline_depth"])
    return counters


def _judge(ctx, c, points, maxiters: int, n_judged: int) -> int:
    rng = np.random.default_rng(derive(ctx.seed, 4))
    picked = sorted(rng.choice(len(points), min(n_judged, len(points)), replace=False))
    wrong = 0
    for index in picked:
        kw, seed, j, pt = points[index]
        # a control's counters are judged by the configuration's float32 reference
        ref = replay(c.name, kw, seed, kw["snrs_db"][j], _first_batch(points, index), maxiters,
                     ctx.device)
        got = {f: getattr(pt, f) for f in COUNTERS}
        want = {f: getattr(ref, f) for f in COUNTERS}
        ok = got == want
        wrong += not ok
        ctx.say(f"judged point {kw['snrs_db'][j]} (seed {seed}): program {got}, "
                f"reference {want}{'' if ok else '  WRONG'}")
    return wrong
