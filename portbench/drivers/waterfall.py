"""A code designer's waterfall: repeated sweeps of the program's
`channel.waterfall.waterfall`.

The traffic file gives the sweep as a list of `calls`, each one call of
`waterfall` with its points (`snrs`: dB, or flip probabilities for `bsc`)
and, where it sets one, its own bits budget in `trials` (max_bits =
trials * k); the rest (`batch`, `decoder`, `noise_model`, `dtype_name`,
`max_bits`, `max_bit_errors`, `pipeline_depth`) is shared. The
configuration gives the code, maxiters and impl. Every call of sweep s
takes the seed derive(run seed, 3, s), as the upstream tools seed every
call of one sweep alike.

Set-up runs one batch of the sweep's first point, which loads the kernels
and builds the tables. The window starts sweeps while it is open; a sweep
runs to its end, so every window holds whole sweeps and the same mix of
points. `waterfall_trials_per_s` is every trial of the sweeps started in the
window over the time from its start to the end of the last.

The judge: `judge_points` points drawn from the seed among all the points
of the window; the reference replays each batch by batch from the same
generators (its copy of the seeding rule) under the stopping rule, and a
point is wrong unless trials, bit errors, frame errors, decode failures and
iterations all equal the reference's.
"""

from __future__ import annotations

import time

import numpy as np

from ..harness import Check, Outcome, derive
from ..reference import channel as ref_channel
from ..reference.codes import code as ref_code

__all__ = ["run", "replay"]

COUNTERS = ("trials", "bit_errors", "frame_errors", "decode_failures", "iterations")
# controls that put the reference in the program's place with its encoder's
# product in a lower precision
ENCODER_CONTROLS = {"encoder_tf32": "tf32", "encoder_bfloat16": "bfloat16"}


def _calls(tr: dict, k: int, dry_run: bool) -> list[dict]:
    """The sweep's calls as keyword arguments of `waterfall` (but seed)."""
    sizes = dict(tr, **tr["dry_run"]) if dry_run else tr
    out = []
    for call in sizes["calls"]:
        trials = call.get("trials")
        out.append(dict(
            snrs_db=call["snrs"], batch=sizes["batch"],
            max_bits=trials * k if trials is not None else sizes["max_bits"],
            max_bit_errors=sizes["max_bit_errors"], noise_model=sizes["noise_model"],
            dtype_name=sizes["dtype_name"], decoder=sizes["decoder"],
            pipeline_depth=sizes["pipeline_depth"]))
    return out


def run(ctx, control: str | None = None) -> Outcome:
    """One run of the cell. `control`, for the control runs only: "bfloat16"
    runs the program's own bf16 LLR path in its place; "encoder_tf32" and
    "encoder_bfloat16" the reference with its encoder's product in TF32 or
    bfloat16."""
    import torch

    from labrador_ldpc_tpu_torch.channel import awgn
    from labrador_ldpc_tpu_torch.channel.waterfall import waterfall

    ctx.mark("import the program")
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    dev, cuda = ctx.device, ctx.device.type == "cuda"
    c = ref_code(cfg["code"])
    dec = cfg["bitflip"] if tr["decoder"] == "bf" else cfg["decoder"]
    maxiters, impl = dec["maxiters"], dec["impl"]
    calls = _calls(tr, c.k, ctx.dry_run)
    if control == "bfloat16":
        calls = [dict(kw, dtype_name="bfloat16") for kw in calls]

    def call(kw: dict, seed: int):
        if control in ENCODER_CONTROLS:
            return _reference_call(c.name, kw, seed, maxiters, dev, ENCODER_CONTROLS[control])
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
    # a dry run makes a fixed number of sweeps, so that the self-tests see the
    # same trials on any machine
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
    t_judge = time.perf_counter()
    wrong = _judge(ctx, c, points, maxiters, tr["judge_points"])
    ctx.say(f"judge: {time.perf_counter() - t_judge:.3f} s")
    # converged codewords ran iterations + 1 sweeps, failed ones maxiters
    counts = {"trials": trials, "sweeps": iterations + trials - failures,
              "dtype": calls[0]["dtype_name"]}
    checks = [Check("points_wrong", wrong, 0)]
    return Outcome(trials, wrong, {"waterfall_trials_per_s": trials / (t_last - t0)}, counts,
                   checks, memory_peak, trace)


def _reference_call(name: str, kw: dict, seed: int, maxiters: int, device, product: str):
    """One `waterfall` call computed by the reference: its points' counters."""
    out, first = [], 0
    for snr in kw["snrs_db"]:
        pt = replay(name, kw, seed, snr, first, maxiters, device, product)
        first += pt.trials // kw["batch"]
        out.append(pt)
    return out


def _first_batch(points, index: int) -> int:
    """The sweep batch index where point `index` of its call starts: each
    point drains exactly trials / batch batches, in launch order."""
    kw, seed, j, _ = points[index]
    start = index - j
    return sum(pt.trials // kw["batch"] for *_, pt in points[start:index])


def replay(name: str, kw: dict, seed: int, snr: float, first_batch: int, maxiters: int,
           device, product: str = "float32") -> ref_channel.Counters:
    """The reference's counters of one point of one `waterfall` call."""
    c = ref_code(name)
    if kw["noise_model"] == "bsc":
        param, noise = snr, "bsc"
    elif kw["noise_model"] == "perftest":
        param, noise = ref_channel.perftest_sigma(snr), "normal"
    else:
        param, noise = ref_channel.ebn0_sigma(snr, c.k / c.n), "normal"

    def batch_counters(index: int) -> ref_channel.Counters:
        gen = ref_channel.batch_generator(seed, index, device)
        data, raw = ref_channel.draw(gen, kw["batch"], c.k, c.n, noise, param, device)
        return ref_channel.trial_counters(name, data, raw, param, kw["decoder"],
                                          kw["noise_model"], maxiters, product)

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
        ref = replay(c.name, kw, seed, kw["snrs_db"][j], _first_batch(points, index),
                     maxiters, ctx.device)
        got = {f: getattr(pt, f) for f in COUNTERS}
        want = {f: getattr(ref, f) for f in COUNTERS}
        ok = got == want
        wrong += not ok
        ctx.say(f"judged point {kw['snrs_db'][j]} (seed {seed}): program {got}, "
                f"reference {want}{'' if ok else '  WRONG'}")
    return wrong
