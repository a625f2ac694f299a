"""The readings that the limits of the comparison are set from, on the card
at the cell's own size: for each seed, a short window of the cell's
traffic, then the frozen float32 reference (on the host's CPU cores)
against the program (the lower readings) and against the control, the same
reference computed in TF32 and put in the program's place (the upper
readings); or, with --fault, the program with that fault planted
(tools/faults.py) against the reference. One process builds the program
once and reads every seed.

    python3 -m mpcbench.tools.control --workload tmpc-corridor --seconds 8 \
        --seeds 11,12,13 --out readings.jsonl [--fault half_left_out]
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def readings(workload: str, seeds, seconds: float, fault=None, control=None, device=None):
    """Yield one record a seed: the compared numbers, wrong answers and
    reported numbers of the program (and of the control on the first
    `control` seeds, all without a fault), against the reference under the
    cell's limits; each checked cycle's or block's readings; the program's
    failed operations. `device`: the program's (None: the card)."""
    import torch

    from mpcbench import cells, judge
    from mpcbench.tools.faults import plant

    cell = cells.cell(workload)
    traffic, limits = cell["traffic"], cell["limits"]
    drv = importlib.import_module(f"mpcbench.drivers.{traffic['driver']}")
    program = drv.Program(cell["config"], device=device)
    control = 0 if fault else len(seeds) if control is None else int(control)
    for n, seed in enumerate(seeds):
        against = ("tf32",) if n < control else ()
        torch.set_num_threads(1)
        with plant(fault):
            out = drv.run(program, traffic, seed, seconds, checked_cycles=limits["checked_cycles"])
        t0 = time.perf_counter()
        rows = []
        res = drv.reference_numbers(out, cell["config"], traffic, seed, against=against,
                                    readings=rows)
        rec = {"workload": workload, "seed": seed, "fault": fault, "limits": limits,
               "reference_s": time.perf_counter() - t0, "cycles": len(out["cycles"]),
               "program_failed_operations": drv.failed_operations(out), "rows": rows}
        for who, checked in (res.items() if against else [("program", res)]):
            rec[who] = judge.verdict(checked, limits)
        yield rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--fault", default=None)
    ap.add_argument("--control", type=int, default=None,
                    help="read the control on the first N seeds (default: all)")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    seeds = [int(s) for s in args.seeds.split(",")]
    for rec in readings(args.workload, seeds, args.seconds, args.fault, args.control):
        with open(args.out, "a") as f:
            f.write(json.dumps(rec, default=float) + "\n")
        summary = {k: rec[k] for k in ("workload", "seed", "fault", "reference_s", "cycles",
                                       "program_failed_operations", "program", "tf32")
                   if k in rec}
        print(json.dumps(summary, default=float), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
