"""The upstream perftest's worker pool as the ranks of a process group:
repeated sweeps of the program's `parallel.launch.distributed_waterfall`,
one rank a card.

Rank 0 is the harness's own process, on card 0; ranks 1 to `ranks` - 1 are
this module run as processes (`python -m portbench.drivers.dp_waterfall`),
started by rank 0, each on card LOCAL_RANK. Every rank calls the program's
`parallel.launch.initialize` (backend and `timeout_s` from the traffic file)
and then `distributed_waterfall` for each call of a sweep: the program
splits every global batch of `batch` codewords over the ranks and sums the
counters, so every rank returns the same points. The calls, their seeding
derive(run seed, 3, sweep) and the judge's draw of points are
`drivers/waterfall.py`'s.

The window: after one warm-up batch on every rank and a barrier, rank 0
decides before each sweep whether the window is still open and sends the
decision with the program's `broadcast_object`; the ranks run the sweeps in
lockstep, and a False ends them. `waterfall_trials_per_s` is every trial of
the global sweeps started in the window over rank 0's time from its start to
the end of the last. A traced run profiles rank 0 alone.

After the window each rank reads its peak memory and frees the program's
state. The judged points are drawn as `drivers/waterfall.py` draws them;
their batches, in order, are cut into one contiguous run a rank, and each
rank has the reference replay its runs (a run of batches is a point with
that bits budget: `replay_run`). A point's runs summed are its replay
wherever the bit-error budget is not reached inside the point; where it is,
rank 0 replays the point whole. Each rank then reports its points, peak
memory, replays and the FORBIDDEN modules it holds (one
`all_gather_object`). A point is wrong unless its five counters equal the
reference's; a rank disagrees unless its points are rank 0's; a rank that
holds a FORBIDDEN module ends the run without a result; the fullest card's
peak is the run's.

The reference decodes a batch with `staged_minsum`: its layered min-sum run
first at a few iterations, then again from the start on the frames left, at
the configuration's maxiters last. Frames never interact in it, and a frame
that converges at iteration i keeps the same bits and iterations under any
maxiters above i, so the result is the single call's.

A bounded failure: rank 0 kills the ranks it started when it returns or
raises; on the card a thread of rank 0 ends its process, non-zero, as soon
as a rank exits with an error; a rank ends when rank 0 does
(PR_SET_PDEATHSIG); and every collective waits at most `timeout_s`.
"""

from __future__ import annotations

import argparse
import inspect
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np

from ..harness import HERE, Check, Outcome, derive, find_cell, forbidden_loaded
from ..reference import channel as ref_channel
from ..reference.codes import code as ref_code
from ..reference.decoders import Result, layered_minsum
from .waterfall import COUNTERS, _calls, _first_batch

__all__ = ["run", "main", "staged_minsum", "replay_run", "judge_runs", "CONTROLS"]

STAGES = (24, 40)  # the judge's maxiters before the configuration's
# controls: "drop_rank" leaves rank 0's counters out of every batch's sum
CONTROLS = ("drop_rank",)


def staged_minsum(c, llrs, maxiters: int, stages=STAGES) -> Result:
    """The reference's `layered_minsum` of every frame at `maxiters`, run at
    each of `stages` below it first and at `maxiters` last, each time on the
    frames not yet converged, from their LLRs."""
    import torch

    first, *later = [m for m in stages if m < maxiters] + [maxiters]
    success, iterations, bits = (t.clone() for t in layered_minsum(c, llrs, first))
    left = torch.nonzero(~success).squeeze(1)
    for m in later:
        if not left.numel():
            break
        res = layered_minsum(c, llrs[left], m)
        success[left], iterations[left], bits[left] = res
        left = left[~res.success]
    return Result(success, iterations, bits)


def replay_run(name: str, kw: dict, seed: int, snr: float, first: int, n: int, maxiters: int,
               device) -> ref_channel.Counters:
    """The reference's counters of `n` batches of one min-sum `waterfall`
    call from sweep batch `first` on, under the stopping rule with a bits
    budget of those `n` batches."""
    c = ref_code(name)
    if kw["noise_model"] == "perftest":
        sigma = ref_channel.perftest_sigma(snr)
    else:
        sigma = ref_channel.ebn0_sigma(snr, c.k / c.n)

    def batch_counters(index: int) -> ref_channel.Counters:
        gen = ref_channel.batch_generator(seed, index, device)
        data, raw = ref_channel.draw(gen, kw["batch"], c.k, c.n, "normal", sigma, device)
        res = staged_minsum(c, ref_channel.bpsk_awgn(ref_channel.encode(name, data), raw, sigma),
                            maxiters)
        err = (res.bits[:, :c.k] != data).sum(dim=1)
        return ref_channel.Counters(data.shape[0], int(err.sum()), int((err > 0).sum()),
                                    int((~res.success).sum()), int(res.iterations.sum()))

    counters, _ = ref_channel.replay_point(batch_counters, first, kw["batch"], c.k,
                                           n * kw["batch"] * c.k, kw["max_bit_errors"],
                                           kw["pipeline_depth"])
    return counters


def judge_runs(points: list, picked: list, k: int, world: int) -> list:
    """The judged points' batches, in order, cut into `world` contiguous
    runs of nearly equal length: for each rank a list of (j, first batch,
    batches), j indexing `picked`."""
    batches = []
    for j, index in enumerate(picked):
        kw = points[index][0]
        first = _first_batch(points, index)
        batches += [(j, first + b) for b in range(-(-kw["max_bits"] // (kw["batch"] * k)))]
    per = -(-len(batches) // world)
    out = []
    for r in range(world):
        mine = batches[r * per:(r + 1) * per]
        out.append([(j, min(b for jj, b in mine if jj == j), sum(jj == j for jj, _ in mine))
                    for j in sorted({j for j, _ in mine})])
    return out


def _picked(seed: int, n_points: int, n_judged: int) -> list:
    """The judged points' indices, drawn as `drivers/waterfall.py` draws them."""
    rng = np.random.default_rng(derive(seed, 4))
    return sorted(int(i) for i in rng.choice(n_points, min(n_judged, n_points), replace=False))


def _sizes(cell, dry_run: bool) -> dict:
    tr = cell.traffic
    return dict(tr, **tr["dry_run"]) if dry_run else tr


def _rank_run(cell, seed: int, rank: int, world: int, port: int, device, dry_run: bool,
             ctx=None, control: str | None = None) -> dict | None:
    """One rank's part of a run: join the group, warm up, run the window's
    sweeps in lockstep, replay this rank's share of the judged points, and
    report. Rank 0 (`ctx` given) also keeps the window's time and trace and
    returns every rank's report with what it kept."""
    import torch
    import torch.distributed as dist

    from labrador_ldpc_tpu_torch.channel import awgn
    from labrador_ldpc_tpu_torch.parallel import mesh as pmesh
    from labrador_ldpc_tpu_torch.parallel.launch import distributed_waterfall, initialize

    sizes, cfg = _sizes(cell, dry_run), cell.config
    c = ref_code(cfg["code"])
    maxiters, impl = cfg["decoder"]["maxiters"], cfg["decoder"]["impl"]
    calls = _calls(cell.traffic, c.k, dry_run)

    def call(kw: dict, s: int):
        return distributed_waterfall(
            code=cfg["code"], snrs_db=kw["snrs_db"], batch=kw["batch"], maxiters=maxiters,
            max_bits=kw["max_bits"], max_bit_errors=kw["max_bit_errors"],
            noise_model=kw["noise_model"], dtype_name=kw["dtype_name"], impl=impl, seed=s,
            decoder=kw["decoder"], pipeline_depth=kw["pipeline_depth"], device=device.type)

    initialize(f"127.0.0.1:{port}", world, rank, sizes["backend"], device.type,
               sizes["timeout_s"])
    try:
        if ctx is not None:
            ctx.mark("the ranks joined the process group")
        mesh = pmesh.make_batch_mesh(device=device.type)
        dev, cuda = mesh.device, mesh.device.type == "cuda"
        first = calls[0]
        call(dict(first, snrs_db=first["snrs_db"][:1], max_bits=first["batch"] * c.k), 0)
        pmesh.all_reduce_sum(mesh, torch.ones(1, device=dev)).item()  # every rank warm
        if ctx is not None:
            ctx.mark("warm-up: one batch of the first point on every rank")

        done: list = []  # (kwargs, seed, points) of every call of the window, in order
        n_fixed = sizes["sweeps"] if dry_run else None

        def sweeps(t_end: float | None) -> float:
            s = 0
            while True:
                go = None
                if rank == 0:
                    go = s < n_fixed if n_fixed is not None else time.perf_counter() < t_end
                if not pmesh.broadcast_object(mesh, go):
                    return time.perf_counter()
                sd = derive(seed, 3, s)
                for kw in calls:
                    done.append((kw, sd, call(kw, sd)))
                s += 1

        trace, t0, t_last = None, 0.0, 0.0
        before = dict(pmesh.collective_calls), dict(pmesh.collective_bytes)
        real_sum = awgn.all_reduce_sum
        if control == "drop_rank":
            awgn.all_reduce_sum = lambda mesh, t: real_sum(mesh, torch.zeros_like(t))
        try:
            if ctx is None:
                sweeps(None)
            elif ctx.trace:
                from ..trace import profiled

                with profiled(dev) as holder:
                    t0 = ctx.window_started()
                    t_last = sweeps(t0 + ctx.seconds)
                trace = holder.trace
            else:
                t0 = ctx.window_started()
                t_last = sweeps(t0 + ctx.seconds)
        finally:
            awgn.all_reduce_sum = real_sum
        window = {kind: (pmesh.collective_calls[kind] - before[0][kind],
                         pmesh.collective_bytes[kind] - before[1][kind])
                  for kind in pmesh.collective_calls}
        memory_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
        if cuda:
            torch.cuda.empty_cache()

        points = [(kw, sd, j, pt) for kw, sd, pts in done for j, pt in enumerate(pts)]
        picked = _picked(seed, len(points), sizes["judge_points"])
        t_judge = time.perf_counter()
        replays = []
        for j, b0, n in judge_runs(points, picked, c.k, world)[rank]:
            kw, sd, i, _ = points[picked[j]]
            got = replay_run(c.name, kw, sd, kw["snrs_db"][i], b0, n, maxiters, dev)
            replays.append((j, [getattr(got, f) for f in COUNTERS]))
        report = {"rank": rank, "device": str(dev), "memory_peak": memory_peak,
                  "forbidden": forbidden_loaded(),
                  "points": [[getattr(pt, f) for f in COUNTERS] for *_, pt in points],
                  "replays": replays, "judge_s": time.perf_counter() - t_judge}
        reports = [None] * world
        dist.all_gather_object(reports, report)
    finally:
        dist.destroy_process_group()
    if ctx is None:
        return None
    return {"reports": reports, "points": points, "picked": picked, "t0": t0,
            "t_last": t_last, "trace": trace, "window": window, "calls": calls, "code": c,
            "maxiters": maxiters, "t_judge": t_judge}


def _judge(ctx, s: dict) -> tuple[int, int]:
    """(points wrong, ranks disagreeing) from the ranks' reports."""
    c, points, picked, reports = s["code"], s["points"], s["picked"], s["reports"]
    disagree = sum(r["points"] != reports[0]["points"] for r in reports)
    sums = {j: ref_channel.Counters() for j in range(len(picked))}
    for r in reports:
        for j, fields in r["replays"]:
            sums[j].add(ref_channel.Counters(*fields))
    wrong = 0
    for j, index in enumerate(picked):
        kw, sd, i, pt = points[index]
        ref = sums[j]
        if ref.bit_errors >= kw["max_bit_errors"]:
            # the budget may have stopped the point inside a run: replay it whole
            n = -(-kw["max_bits"] // (kw["batch"] * c.k))
            ref = replay_run(c.name, kw, sd, kw["snrs_db"][i], _first_batch(points, index), n,
                             s["maxiters"], ctx.device)
        got = {f: getattr(pt, f) for f in COUNTERS}
        want = {f: getattr(ref, f) for f in COUNTERS}
        ok = got == want
        wrong += not ok
        ctx.say(f"judged point {kw['snrs_db'][i]} (seed {sd}): program {got}, "
                f"reference {want}{'' if ok else '  WRONG'}")
    return wrong, disagree


class _Watch:
    """A thread that ends this process, non-zero, when a rank it watches
    exits with an error: rank 0 would otherwise wait for it inside a
    collective on the card until the process group's timeout."""

    def __init__(self, procs, log):
        self.procs, self.log = procs, log
        self.stopped = threading.Event()
        self.thread = threading.Thread(target=self._watch, daemon=True)
        self.thread.start()

    def _watch(self):
        while not self.stopped.wait(0.2):
            for r, p in self.procs:
                if p.poll() not in (None, 0):
                    print(f"portbench: rank {r} exited {p.returncode}; ending the run",
                          file=self.log, flush=True)
                    _kill(self.procs)
                    os._exit(1)

    def stop(self):
        self.stopped.set()
        self.thread.join()


def _kill(procs) -> None:
    for _, p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def run(ctx, control: str | None = None) -> Outcome:
    """One run of the cell, as its rank 0. `control`, for the control runs
    only: "drop_rank" leaves rank 0's counters out of every batch's sum."""
    from labrador_ldpc_tpu_torch.parallel import launch

    if "timeout" not in inspect.signature(launch.initialize).parameters:
        raise SystemExit("portbench: this program's parallel.launch.initialize takes no timeout: "
                         "a rank that died would hold the others for the backend's default")
    if control not in (None, *CONTROLS):
        raise ValueError(f"unknown control {control!r} ({', '.join(CONTROLS)})")
    ctx.mark("import the program")
    sizes = _sizes(ctx.cell, ctx.dry_run)
    world = sizes["ranks"]
    if ctx.device.type == "cuda":
        from labrador_ldpc_tpu_torch.ops import _nvcc, cuda_encoder, cuda_layered

        for source in (cuda_layered.SOURCE, cuda_encoder.SOURCE):
            _nvcc.build(source)  # once, before the ranks would each build them
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")  # one host
    port = launch.free_port()
    procs = []
    watch = None
    try:
        for r in range(1, world):
            argv = [sys.executable, "-m", "portbench.drivers.dp_waterfall", "--workload",
                    ctx.cell.name, "--seed", str(ctx.seed), "--rank", str(r), "--world",
                    str(world), "--port", str(port), "--parent", str(os.getpid())]
            procs.append((r, subprocess.Popen(
                argv + (["--dry-run"] if ctx.dry_run else []), cwd=HERE.parent, stdout=2,
                env=dict(os.environ, LOCAL_RANK=str(r)))))
        if sizes["backend"] == "nccl":
            watch = _Watch(procs, ctx.log)
        ctx.mark(f"start ranks 1-{world - 1}")
        s = _rank_run(ctx.cell, ctx.seed, 0, world, port, ctx.device, ctx.dry_run, ctx, control)
        for r, p in procs:
            if p.wait(timeout=sizes["timeout_s"]) != 0:
                raise RuntimeError(f"portbench: rank {r} exited {p.returncode}")
    finally:
        if watch is not None:
            watch.stop()
        _kill(procs)

    points, reports = s["points"], s["reports"]
    trials = sum(pt.trials for *_, pt in points)
    failures = sum(pt.decode_failures for *_, pt in points)
    iterations = sum(pt.iterations for *_, pt in points)
    ctx.say(f"waterfall: {world} ranks ({sizes['backend']}), {len(points)} points, {trials} "
            f"trials in {s['t_last'] - s['t0']:.3f} s; {failures} decode failures; rank 0's "
            f"collectives in the window (calls, bytes): {s['window']}")
    runs = judge_runs(points, s["picked"], s["code"].k, world)
    for r in reports:
        ctx.say(f"rank {r['rank']} ({r['device']}): peak memory {r['memory_peak']} B, judged "
                f"{sum(n for *_, n in runs[r['rank']])} batches in {r['judge_s']:.3f} s")
    found = sorted({m for r in reports for m in r["forbidden"]})
    if found:
        raise SystemExit(f"portbench: a rank holds {', '.join(found)} after the window")
    wrong, disagree = _judge(ctx, s)
    ctx.say(f"judge: {time.perf_counter() - s['t_judge']:.3f} s")
    counts = {"trials": trials, "sweeps": iterations + trials - failures,
              "dtype": s["calls"][0]["dtype_name"]}
    checks = [Check("points_wrong", wrong, 0), Check("ranks_disagreeing", disagree, 0)]
    return Outcome(trials, wrong, {"waterfall_trials_per_s": trials / (s["t_last"] - s["t0"])},
                   counts, checks, max(r["memory_peak"] for r in reports), s["trace"])


def _die_with(parent: int) -> None:
    """SIGKILL this process when the process that started it ends."""
    import ctypes

    ctypes.CDLL(None).prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG
    if os.getppid() != parent:
        os._exit(1)


def main(argv=None) -> int:
    """Ranks 1 and up of a cell: run by rank 0, never by hand."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    for name in ("--rank", "--world", "--port", "--parent", "--seed"):
        ap.add_argument(name, type=int, required=True)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--dry-run", action="store_true")
    args = ap.parse_args(argv)
    _die_with(args.parent)
    import torch

    if args.dry_run:
        torch.set_num_threads(1)
    cell = find_cell(args.workload)
    device = torch.device("cpu" if args.dry_run else "cuda")
    _rank_run(cell, args.seed, args.rank, args.world, args.port, device, args.dry_run)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
