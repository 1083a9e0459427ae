#!/usr/bin/env python3
"""A sweep of one cell's traffic parameter, one run a value, in one
process: how a cell's fixed load was chosen (the stream cell's count of
streams is 4/5 of the knee, the most streams at which the 95th percentile
of the reply time stays under the message period with no growing
backlog).

    python3 benchmark/sweep.py --workload wsj_fdlp_e2e.stream \
        --param streams --values 4 6 8 10 12 --seconds 50 --seed 5

One JSON line a value: the end-to-end metrics, attempted and failed, and
the facts the driver recorded (the stream driver's median reply, the
clients' send lag, the batcher's rounds).
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser("sweep a cell's traffic parameter")
    p.add_argument("--workload", required=True)
    p.add_argument("--param", required=True)
    p.add_argument("--values", type=float, nargs="+", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seed", type=int, required=True)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        print("sweep: no CUDA card", file=sys.stderr)
        return 2
    for v in args.values:
        value = int(v) if float(v).is_integer() else v
        box = {}

        def prepare(ctx):
            ctx.cell["params"][args.param] = value
            box["ctx"] = ctx

        result = harness.run_cell(args.workload, args.seed, args.seconds, False,
                                  torch.device("cuda", 0), time.perf_counter(),
                                  prepare=prepare)
        facts = {k: v for k, v in box["ctx"].facts.items()
                 if isinstance(v, (int, float, list)) or v is None}
        print(json.dumps({args.param: value, "correct": result["correct"],
                          "attempted": result["attempted"], "failed": result["failed"],
                          "metrics": {k: m["value"] for k, m in result["metrics"].items()},
                          "facts": facts}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
