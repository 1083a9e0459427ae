#!/usr/bin/env python3
"""Readings that set a cell's correctness limits: the program's, and the
control's (the plain reference computed in TF32, the precision below the
configurations' float32 with TF32 off, in the program's place), and for
training the planted faults' (the reference with half of each batch),
seed by seed, in one process:

    python3 benchmark/calibrate.py --workload wsj_fdlp_e2e.decode \
        --seconds 40 --seeds 11 12 13 [--out chiprun_out/calib.jsonl]

Each seed is a whole run of the cell (set-up, a window of `--seconds`,
the check) with the control computed beside the reference and judged in
the program's place, so that the run's `correct` is the control's; the
program's own readings are kept beside it. One JSON line per seed. A
limit lies above every program reading and below every
control reading, with room on both sides (PERF.md gives the readings).
The benchmark's own runs never compute the control.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser("calibrate a cell's correctness limits")
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--out")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    lines = []
    for seed in args.seeds:
        facts = {}

        def prepare(ctx):
            ctx.facts["control"] = True
            facts["ctx"] = ctx

        t0 = time.perf_counter()
        result = harness.run_cell(args.workload, seed, args.seconds, False, dev, t0,
                                  prepare=prepare)
        ctx = facts["ctx"]
        program = ctx.facts.get("readings")
        # "correct": the run's own check, the control judged in the
        # program's place (false where the control fails a limit)
        line = {"workload": args.workload, "seed": seed, "correct": result["correct"],
                "program_correct": all(program[k] <= lim
                                       for k, lim in ctx.cell["limits"].items()),
                "program": program,
                "control": ctx.facts.get("control_readings"),
                "faults": ctx.facts.get("fault_readings"),
                "metrics": {k: v["value"] for k, v in result["metrics"].items()},
                "seconds": time.perf_counter() - t0}
        lines.append(line)
        print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
