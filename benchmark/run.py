#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, from the root of a checkout:

    python3 benchmark/run.py --workload wsj_fdlp_e2e.decode --seed 1234 \
        --seconds 40 --trace 0

The last line of standard output is the result as one JSON object
(`correct`, `attempted`, `failed`, `metrics`, `device`, with `--trace 1`
`breakdown`, and last `checks`: each number the correctness check compared,
beside its limit). The same numbers end standard error. Exit codes: 0 with
a result; 2 without a CUDA card (or fewer than the cell needs); 3 when a
module of JAX or of the JAX package was loaded; anything else is a fault
of the run.
"""

import time

_T_CALL = time.perf_counter()


def _process_age_s() -> float:
    """Seconds since this process started (Linux /proc; 0 elsewhere)."""
    import os

    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


# the perf_counter reading at which the process started
T_START = _T_CALL - _process_age_s()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cache_dirs():
    """Build and kernel caches at fixed paths inside the checkout, so that
    only a cell's first run there builds (the port's K1 library goes to its
    own `_build/`, inside the checkout too)."""
    cache = os.path.join(ROOT, ".bench_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv_compute")):
        os.environ[var] = os.path.join(cache, sub)
        os.makedirs(os.environ[var], exist_ok=True)


def get_parser():
    p = argparse.ArgumentParser("the port's benchmark: one cell, one run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=[0, 1], default=0)
    return p


def main(argv=None) -> int:
    args = get_parser().parse_args(argv)
    _cache_dirs()
    sys.path.insert(0, ROOT)
    import torch

    from benchmark import harness

    cells = {w["name"]: w for w in harness.spec()["workloads"]}
    cell, _ = harness.load_cell(args.workload)
    chips = cells.get(args.workload, cell).get("chips", 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    try:
        result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                                  torch.device("cuda", 0), T_START)
    except harness.IsolationError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
