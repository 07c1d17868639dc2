"""A ground station's bulk decode of a stream of received frames.

The traffic file gives the channel (BPSK over AWGN at `ebn0_db`), the soft
decisions' form (`llr`: float32 y, or int8 clip(round(scale * y))), the
batch, the pool of distinct batches, the batches in flight (`depth`) and
the frames a batch that the judge samples.

Set-up draws the pool on the card from the seed (data bits, the
reference's encoder, the noise), holds it in pinned host memory, and runs
it once through the loop to warm every shape. The window is a closed loop
after the program's `serve.py`: it cycles the pool, and per batch calls the
program's `ops.minsum.decode_ms` on the host batch and `ops.convert.pack_bits`
on the data bits, copies the success flags, iterations, packed data bytes
and the sampled frames' bits to pinned host slots without blocking, and
reads each slot once its CUDA event has fired (polled after every launch;
with `depth` batches out, it waits for the oldest). A batch's latency runs
from the call that hands over its host batch to its results readable on
the host. `stream_frames_per_s` is every frame of the batches launched in
the window over the time from the window's start to the last result read.

The judge: per batch, `sample_per_batch` frames drawn from the seed plus
the frame that took most iterations; after the window the plain reference
decodes their LLRs, and a frame is wrong unless its bits, success,
iterations and packed data bytes all equal the reference's.
"""

from __future__ import annotations

import time
from collections import deque

import numpy as np

from ..harness import Check, Outcome, derive
from ..reference import channel as ref_channel
from ..reference.codes import code as ref_code
from ..reference.decoders import layered_minsum

__all__ = ["run"]

MAX_BATCHES = 1 << 14  # sample indices drawn ahead for this many batches
INT_BOUNDS = {"int8": (-128, 127), "int4": (-8, 7)}


def _quantize(y, scale: float, bounds):
    import torch

    return torch.clamp(torch.round(y * scale), *bounds).to(torch.int8)


def _pool(ctx, c, sigma: float, n_batches: int, batch: int, llr: dict, control: str | None):
    """The pool: host tensors (pinned on a card) of the program's LLRs, and
    the LLRs the reference decodes (the same ones, but for the int4 control,
    whose program input is y quantized to int4 at scale/16)."""
    import torch

    dev = ctx.device
    gen = torch.Generator(device=dev).manual_seed(derive(ctx.seed, 1))
    pin = dev.type == "cuda"
    program, reference = [], []
    for _ in range(n_batches):
        data = torch.randint(0, 2, (batch, c.k), generator=gen, device=dev, dtype=torch.uint8)
        cw = ref_channel.encode(c.name, data)
        y = ref_channel.bpsk_awgn(cw, torch.randn((batch, c.n), generator=gen, device=dev), sigma)
        x = y if llr["dtype"] == "float32" else _quantize(y, llr["scale"], INT_BOUNDS["int8"])
        feed = {None: x, "bfloat16": x.to(torch.bfloat16),
                "int4": _quantize(y, llr.get("scale", 16) / 16, INT_BOUNDS["int4"])}[control]
        for out, t in ((program, feed), (reference, x)) if control else ((program, x),):
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=pin)
            host.copy_(t)
            out.append(host)
        del data, cw, y, x, feed
    return program, reference if control else program


def run(ctx, control: str | None = None) -> Outcome:
    """One run of the cell. `control` puts a lower precision in the
    program's place ("bfloat16": the program's own bf16 path; "int4": the
    reference at int4), for the control runs only."""
    import torch

    from labrador_ldpc_tpu_torch.ops import convert, minsum

    ctx.mark("import the program")
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    sizes = dict(tr, **tr["dry_run"]) if ctx.dry_run else tr
    dev, cuda = ctx.device, ctx.device.type == "cuda"
    c = ref_code(cfg["code"])
    maxiters, impl = cfg["decoder"]["maxiters"], cfg["decoder"]["impl"]
    batch, depth, per = sizes["batch"], tr["depth"], tr["sample_per_batch"]
    llr = tr["llr"]
    sigma = ref_channel.ebn0_sigma(tr["ebn0_db"], c.k / c.n)
    pool, ref_pool = _pool(ctx, c, sigma, sizes["pool_batches"], batch, llr, control)
    rng = np.random.default_rng(derive(ctx.seed, 2))
    picks = rng.integers(0, batch, (MAX_BATCHES, per))
    picks_dev = torch.as_tensor(picks, device=dev)
    ctx.mark("inputs: the pool drawn, encoded and pinned")

    if control == "int4":
        def decode(x):
            r = layered_minsum(c, x.to(dev), maxiters, INT_BOUNDS["int4"])
            return r.success, r.iterations, r.bits, ref_channel.pack(r.bits[:, :c.k])
    else:
        def decode(x):
            r = minsum.decode_ms(cfg["code"], x, maxiters=maxiters, impl=impl, device=dev)
            return r.success, r.iterations, r.bits, convert.pack_bits(r.bits[:, :c.k], dev)

    def slot():
        return [torch.empty(shape, dtype=dt, pin_memory=cuda) for shape, dt in (
            ((batch,), torch.bool), ((batch,), torch.int32), ((batch, c.k // 8), torch.uint8),
            ((per + 1, c.n_vars), torch.uint8), ((per + 1,), torch.int64))]

    slots = [slot() for _ in range(depth)]
    inflight: deque = deque()
    kept: list = []  # (pool index, rows, bits, success, iterations, data) of each batch read
    stats = {"frames": 0, "batches": 0, "sweeps": 0, "failures": 0}
    latencies: list = []

    def launch(i: int):
        t_call = time.perf_counter()
        success, iters, bits, data = decode(pool[i % len(pool)])
        rows = torch.cat([picks_dev[i % MAX_BATCHES], iters.argmax().view(1)])
        out = slots[i % depth]
        for dst, src in zip(out, (success, iters, data, bits.index_select(0, rows), rows)):
            dst.copy_(src, non_blocking=cuda)
        done = None
        if cuda:
            done = torch.cuda.Event()
            done.record()
        inflight.append((i, t_call, out, done))

    def read(record: bool):
        i, t_call, (ok, iters, data, bits, rows), done = inflight.popleft()
        if done is not None:
            done.synchronize()
        if record:
            latencies.append(time.perf_counter() - t_call)
        r = rows.numpy().copy()
        it = iters.numpy()
        okn = ok.numpy()
        kept.append((i % len(pool), r, bits.numpy().copy(), okn[r].copy(), it[r].copy(),
                     data.numpy()[r].copy()))
        stats["frames"] += batch
        stats["batches"] += 1
        stats["sweeps"] += int(it.sum(dtype=np.int64)) + int(okn.sum())
        stats["failures"] += int((~okn).sum())

    def loop(n_batches: int | None, t_end: float | None, record: bool) -> float:
        i = 0
        while (n_batches is not None and i < n_batches) or \
                (t_end is not None and time.perf_counter() < t_end):
            launch(i)
            i += 1
            while inflight and (inflight[0][3] is None or inflight[0][3].query()):
                read(record)
            if len(inflight) >= depth:
                read(record)
        while inflight:
            read(record)
        return time.perf_counter()

    loop(len(pool), None, False)  # warm-up: every shape, the allocator's blocks, the kernel
    if cuda:
        torch.cuda.synchronize(dev)
    ctx.mark("warm-up: the pool once through the loop")
    kept.clear()
    stats.update(frames=0, batches=0, sweeps=0, failures=0)
    # a dry run reads a fixed number of batches, so that the self-tests see
    # the same frames on any machine
    n_fixed = sizes["batches"] if ctx.dry_run else None
    trace = None
    if ctx.trace:
        from ..trace import profiled

        with profiled(dev) as holder:
            t0 = ctx.window_started()
            t_last = loop(n_fixed, None if n_fixed else t0 + ctx.seconds, True)
        trace = holder.trace
    else:
        t0 = ctx.window_started()
        t_last = loop(n_fixed, None if n_fixed else t0 + ctx.seconds, True)
    if not stats["batches"]:
        raise RuntimeError("the window read no batch")
    memory_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    ctx.say(f"stream: {stats['batches']} batches, {stats['frames']} frames in "
            f"{t_last - t0:.3f} s; {stats['failures']} frames did not converge; "
            f"mean sweeps a frame {stats['sweeps'] / max(stats['frames'], 1):.3f}")
    del slots, inflight, picks_dev, pool
    if cuda:
        torch.cuda.empty_cache()

    t_judge = time.perf_counter()
    wrong = _judge(c, ref_pool, kept, maxiters, llr, dev)
    ctx.say(f"judge: {time.perf_counter() - t_judge:.3f} s")
    metrics = {
        "stream_frames_per_s": stats["frames"] / (t_last - t0),
        "stream_batch_p95_ms": 1e3 * float(np.percentile(latencies, 95)) if latencies else 0.0,
    }
    counts = dict(stats, dtype=llr["dtype"])
    checks = [Check("frames_wrong", wrong, 0)]
    return Outcome(stats["frames"], wrong, metrics, counts, checks, memory_peak, trace)


def _judge(c, ref_pool, kept, maxiters: int, llr: dict, dev) -> int:
    """Decode every kept frame's LLRs with the reference; count the frames
    whose outputs differ in anything."""
    import torch

    bounds = None if llr["dtype"] == "float32" else INT_BOUNDS[llr["dtype"]]
    unique = sorted({(p, int(r)) for p, rows, *_ in kept for r in rows})
    where = {key: j for j, key in enumerate(unique)}
    out = {"bits": [], "success": [], "iterations": [], "data": []}
    for lo in range(0, len(unique), 1024):
        part = unique[lo:lo + 1024]
        x = torch.stack([ref_pool[p][r] for p, r in part]).to(dev)
        res = layered_minsum(c, x, maxiters, bounds)
        out["bits"].append(res.bits.cpu().numpy())
        out["success"].append(res.success.cpu().numpy())
        out["iterations"].append(res.iterations.cpu().numpy())
        out["data"].append(ref_channel.pack(res.bits[:, :c.k]).cpu().numpy())
    ref = {k: np.concatenate(v) for k, v in out.items()}
    wrong = 0
    for p, rows, bits, ok, iters, data in kept:
        j = np.array([where[(p, int(r))] for r in rows])
        bad = (bits != ref["bits"][j]).any(axis=1) | (ok != ref["success"][j]) | \
            (iters != ref["iterations"][j]) | (data != ref["data"][j]).any(axis=1)
        wrong += int(bad.sum())
    return wrong
