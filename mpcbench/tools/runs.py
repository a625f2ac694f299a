"""Run cells of the benchmark one after another, each run its own process,
as a check of the benchmark runs them, and keep every result line.

    python3 -m mpcbench.tools.runs --out runs.jsonl \
        --run tmpc-corridor:11:30:0 --run tmpc-corridor:12:30:0 ...

Each --run is cell:seed:seconds:trace. The summary printed at the end gives
each run's metrics, set-up time, correct and its compared numbers; the
JSONL file keeps the whole result line and the end of standard error.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def one(cell: str, seed: int, seconds: float, trace: int, timeout: float = 1500) -> dict:
    cmd = [sys.executable, os.path.join(ROOT, "mpcbench", "run.py"), "--workload", cell,
           "--seed", str(seed), "--seconds", str(seconds), "--trace", str(trace)]
    t0 = time.perf_counter()
    try:
        p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=timeout)
        rc, out, err = p.returncode, p.stdout, p.stderr
    except subprocess.TimeoutExpired as e:
        rc, out, err = 124, e.stdout or "", e.stderr or ""
        out = out if isinstance(out, str) else out.decode()
        err = err if isinstance(err, str) else err.decode()
    wall = time.perf_counter() - t0
    lines = [line for line in out.strip().splitlines() if line.strip()]
    try:
        result = json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        result = None
    return {"cell": cell, "seed": seed, "seconds": seconds, "trace": trace, "rc": rc,
            "wall_s": wall, "result": result, "stderr_tail": err[-3000:]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--run", action="append", default=[])
    args = ap.parse_args(argv)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    for spec in args.run:
        cell, seed, seconds, trace = spec.split(":")
        rec = one(cell, int(seed), float(seconds), int(trace))
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        r = rec["result"] or {}
        metrics = {k: round(v["value"], 4) for k, v in r.get("metrics", {}).items()}
        checks = {k: v["value"] for k, v in r.get("checks", {}).items()}
        print(f"{cell} seed={seed} trace={trace} rc={rec['rc']} wall={rec['wall_s']:.1f} "
              f"correct={r.get('correct')} attempted={r.get('attempted')} failed={r.get('failed')} "
              f"{json.dumps(metrics)} checks={json.dumps(checks)}", flush=True)
        if rec["rc"] != 0 or not r:
            print(rec["stderr_tail"][-1500:], flush=True)
        else:
            print("  " + " | ".join(l for l in rec["stderr_tail"].splitlines()
                                    if l.startswith("mpcbench:"))[:1200], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
