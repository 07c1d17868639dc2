"""The four-card waterfall's path (`parallel.launch.distributed_waterfall`)
on the CPU, at the sizes of the benchmark cell's dry run, against the
benchmark's plain reference (`portbench/reference/`), with no JAX.

Two Gloo ranks run the dry run's points (TM8192, maxiters 100, a global
batch of 8, one and two batches). Every rank draws the whole global batch
and decodes its half, and the counters are summed with one `all_reduce` a
batch, so each point's five counters must equal the reference's replay of
the whole global batch, batch by batch: exact. In the same rank processes,
under a CPU-only `torch.profiler`: the sweep opens one `ldpc.all_reduce`
span a batch drained and counts one `all_reduce` call of the five int32
counters a batch in `parallel.mesh.collective_calls` and
`collective_bytes`; before the process group exists, the same sweep on a
mesh of one rank opens no collective span and counts nothing. About 17 s
alone.
"""

import json
import os
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from labrador_ldpc_tpu_torch.parallel.launch import free_port, run_processes
from portbench.drivers.waterfall import COUNTERS, replay

REPO = Path(__file__).resolve().parent.parent
TRAFFIC = json.loads((REPO / "portbench/traffic/dp_ms_ebn0_sweep.json").read_text())
CONFIG = json.loads((REPO / "portbench/configs/TM8192_DP4.json").read_text())
DRY = dict(TRAFFIC, **TRAFFIC["dry_run"])
SEED = 2_147_483_659  # above 2**31
K = CONFIG["k"]
# the dry run's calls as keyword arguments of `waterfall`, one point each
CALLS = [dict(snrs_db=c["snrs"], batch=DRY["batch"], maxiters=CONFIG["decoder"]["maxiters"],
              max_bits=c["trials"] * K, max_bit_errors=DRY["max_bit_errors"],
              noise_model=DRY["noise_model"], dtype_name=DRY["dtype_name"],
              impl=CONFIG["decoder"]["impl"], seed=SEED, decoder=DRY["decoder"],
              pipeline_depth=DRY["pipeline_depth"])
         for c in DRY["calls"]]
BATCHES = sum(c["trials"] // DRY["batch"] for c in DRY["calls"])
COLLECTIVE_SPANS = ("ldpc.all_reduce", "ldpc.all_gather", "ldpc.broadcast")

# one rank: the sweep on a mesh of one rank, then on the process group, each
# under a CPU-only profiler; writes the points, span counts and counters
RANK_PROGRAM = textwrap.dedent("""
    import json, sys
    import torch
    torch.set_num_threads(1)
    from labrador_ldpc_tpu_torch.channel.waterfall import waterfall
    from labrador_ldpc_tpu_torch.parallel import mesh as pmesh
    from labrador_ldpc_tpu_torch.parallel.launch import distributed_waterfall, initialize
    rank, port, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    calls, names = json.load(open(f"{work}/calls.json"))

    def profiled(sweep):
        counts = {k: (pmesh.collective_calls[k], pmesh.collective_bytes[k])
                  for k in pmesh.collective_calls}
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            points = [pt for kw in calls for pt in sweep(kw)]
        # the exported trace is read many times faster than prof.events() is built
        prof.export_chrome_trace(f"{work}/trace{rank}.json")
        spans = [e["name"] for e in json.load(open(f"{work}/trace{rank}.json"))["traceEvents"]
                 if e.get("ph") == "X" and e["name"] in names]
        moved = {k: [pmesh.collective_calls[k] - c, pmesh.collective_bytes[k] - b]
                 for k, (c, b) in counts.items()}
        return {"points": [[p.trials, p.bit_errors, p.frame_errors, p.decode_failures,
                            p.iterations] for p in points],
                "spans": {n: spans.count(n) for n in names}, "counted": moved}

    alone = pmesh.make_batch_mesh(device="cpu")
    out = {"alone": profiled(lambda kw: waterfall(code="TM8192", device="cpu", mesh=alone,
                                                  **kw))}
    initialize(f"127.0.0.1:{port}", 2, rank, device="cpu", timeout=120)
    out["ranks"] = profiled(lambda kw: distributed_waterfall(code="TM8192", device="cpu", **kw))
    json.dump(out, open(f"{work}/rank{rank}.json", "w"))
    torch.distributed.destroy_process_group()
""")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run PyTorch's CPU ops on one thread (tests/test_torch_layered.py)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """RANK_PROGRAM's results on two Gloo ranks, by rank."""
    work = tmp_path_factory.mktemp("dp_ranks")
    (work / "calls.json").write_text(json.dumps([CALLS, COLLECTIVE_SPANS]))
    port = free_port()
    run_processes([[sys.executable, "-c", RANK_PROGRAM, str(r), str(port), str(work)]
                   for r in (0, 1)], timeout=240, cwd=REPO,
                  env=dict(os.environ, OMP_NUM_THREADS="1"))
    return [json.loads((work / f"rank{r}.json").read_text()) for r in (0, 1)]


@pytest.fixture(scope="module")
def reference():
    """The reference's replay of each dry-run point, the whole global batch."""
    out = []
    for kw in CALLS:
        kw = dict(kw, batch=DRY["batch"])
        ref = replay("TM8192", kw, SEED, kw["snrs_db"][0], 0, kw["maxiters"],
                     torch.device("cpu"))
        out.append([getattr(ref, f) for f in COUNTERS])
    return out


def test_dry_run_sizes():
    assert DRY["ranks"] == 2 and DRY["backend"] == "gloo" and len(CALLS) == 2
    assert DRY["batch"] % DRY["ranks"] == 0 and BATCHES == 3


@pytest.mark.parametrize("rank", [0, 1])
def test_counters_equal_the_reference_replay(two_ranks, reference, rank):
    assert two_ranks[rank]["ranks"]["points"] == reference
    assert [p[0] for p in reference] == [c["trials"] for c in DRY["calls"]]


@pytest.mark.parametrize("rank", [0, 1])
def test_one_rank_equals_two(two_ranks, rank):
    assert two_ranks[rank]["alone"]["points"] == two_ranks[rank]["ranks"]["points"]


@pytest.mark.parametrize("rank", [0, 1])
def test_one_all_reduce_span_and_count_a_batch(two_ranks, rank):
    got = two_ranks[rank]["ranks"]
    assert got["spans"] == {"ldpc.all_reduce": BATCHES, "ldpc.all_gather": 0,
                            "ldpc.broadcast": 0}
    # five int32 counters a batch
    assert got["counted"] == {"all_reduce": [BATCHES, BATCHES * 5 * 4], "all_gather": [0, 0],
                              "broadcast": [0, 0]}


@pytest.mark.parametrize("rank", [0, 1])
def test_no_span_and_no_count_without_a_process_group(two_ranks, rank):
    got = two_ranks[rank]["alone"]
    assert got["spans"] == dict.fromkeys(COLLECTIVE_SPANS, 0)
    assert got["counted"] == {k: [0, 0] for k in ("all_reduce", "all_gather", "broadcast")}
