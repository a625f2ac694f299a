"""One run of one cell of the port's benchmark.

    python3 mpcbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

(or `python3 -m mpcbench.run ...`), from the root of a checkout that holds
BENCHMARK.json and mpc_planner_tpu_torch. It drives the port on cuda:0 and
stops with a non-zero code, printing no result, without a card, with a
part of the cell missing, or when anything of JAX or the JAX package was
loaded. Set-up (the program's build, its kernels' build or load, the
scenes, one warm-up episode or warm cycles) runs from the seed; then the
window measures for `--seconds`; then the frozen float32 reference
(mpcbench/reference/, in worker processes on the host's CPU cores, which
never open the card) checks the answers drawn from the seed.

Standard error carries the run's planning outcomes and, as its last lines,
every compared number beside its limit. The last line of standard output
is one JSON object: correct, attempted, failed, metrics (the cell's
end-to-end metrics with --trace 0, its per-layer metrics with --trace 1),
device, with --trace 1 breakdown, and checks (the compared numbers) last.
"""

from __future__ import annotations

import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# Every build and kernel cache of the run stays in the checkout, at fixed
# paths: the second run of a cell finds what the first one built.
CACHE = os.path.join(ROOT, ".mpcbench_cache")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["USE_FLAX"] = "0"
# One process with one thread of numerical work: the host side of the
# program is small arrays, and threads that spin on a shared host only
# widen the spread between runs.
for _name in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_name] = "1"
RUNS_DIR = os.path.join(ROOT, ".mpcbench_runs")


def process_start_perf() -> float:
    """This process's start on the perf_counter clock (from /proc), or the
    moment this module was loaded where /proc cannot say."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        return time.perf_counter() - max(age, 0.0)
    except (OSError, ValueError, IndexError):
        return time.perf_counter()


PROCESS_START = process_start_perf()


def parse(argv):
    import argparse

    ap = argparse.ArgumentParser(description="One run of one cell of the port's benchmark.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def fail(msg: str, code: int = 2):
    print(f"mpcbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def main(argv=None) -> int:
    args = parse(argv)
    from mpcbench import cells, guard

    try:
        cell = cells.cell(args.workload)
    except (cells.MissingPart, KeyError, ValueError) as e:
        fail(f"cannot read the cell: {e}")
    import torch

    from mpcbench import device as dev

    chips = int(cell["workload"]["chips"])
    try:
        dev.require_cards(chips)
    except dev.NoCard as e:
        fail(str(e))
    try:
        import mpc_planner_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"the program is not in the checkout: {e}")
    from mpcbench import engine

    result, stderr_lines = engine.run_cell(cell, args.workload, args.seed, args.seconds,
                                           bool(args.trace), PROCESS_START)
    found = guard.forbidden_loaded()
    if found:
        fail(f"modules of JAX or the JAX package were loaded: {', '.join(found)}")
    os.makedirs(RUNS_DIR, exist_ok=True)
    engine.write_run_file(RUNS_DIR, args, result)
    for line in stderr_lines:
        print(line, file=sys.stderr, flush=True)
    print(engine.result_line(result), flush=True)
    del torch
    return 0


if __name__ == "__main__":
    sys.exit(main())
