"""Control runs: a cell with a lower precision put in the program's place,
judged as a run is judged. Each must come out not correct.

    python3 -m portbench.control --workload <cell> --control <kind> --seeds 1,2,3 [--seconds s]

Kinds: "bfloat16" (the program's own bfloat16 path: the stream's LLRs, or
the waterfall's `dtype_name`), "int4" (the stream's reference decoder at
int4 saturation on y quantized at a sixteenth of the int8 scale),
"encoder_tf32" and "encoder_bfloat16" (a waterfall's trials computed by the
reference with its GF(2) product in TF32 or bfloat16). One JSON line a
seed: the checks with their values and limits. The benchmark's own runs
never run this.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    from .run import _environment

    _environment()
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--control", required=True,
                    choices=("bfloat16", "int4", "encoder_tf32", "encoder_bfloat16"))
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--dry-run", action="store_true")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)

    import torch

    from .harness import Context, find_cell

    cell = find_cell(args.workload)
    device = torch.device("cpu" if args.dry_run else "cuda")
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = Context(cell, seed, args.seconds, False, device, args.dry_run)
        outcome = cell.driver.run(ctx, control=args.control)
        print(json.dumps({"workload": cell.name, "control": args.control, "seed": seed,
                          "correct": all(c.ok for c in outcome.checks),
                          "checks": {c.name: {"value": c.value, "limit": c.limit}
                                     for c in outcome.checks}}), flush=True)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
