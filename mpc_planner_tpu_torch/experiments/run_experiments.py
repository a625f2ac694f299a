"""Every experiment of the port on the card, one process each, with
the arguments PERF.md reports, each one's output kept in a file.

    python -m mpc_planner_tpu_torch.experiments.run_experiments [--out DIR] [--only NAME ...]

Runs in turn (NAME: experiment and arguments):
  corridor_table    corridor_benchmark --config all --peds 4 8 12 --seeds 3
  corridor_shmpc    corridor_benchmark --config shmpc --peds 12 --seeds 3
  corridor_prm      corridor_benchmark --config tmpc --backend prm --peds 12 --seeds 3
  corridor_wide     corridor_benchmark --config tmpc --samples-per-class 250 --peds 12 --seeds 3
  shmpc_route       shmpc_route (12 pedestrians, seed 0, 40 steps a route)
  verify_prm_drive, guidance_ab, horizon_sweep, batch_sweep, n30_latency,
  profile_solve, fused_rti_check, scaling_sweep: their defaults
  nvar8_stress_1-4  nvar8_stress in four fresh processes
(the corridor runs with --json). Each writes DIR/NAME.txt (its standard
output, then its standard error); a summary line per run (exit code,
seconds) and the card's name and power limit are printed. The kernels
build into the package's _build/ once and are shared by the later runs.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

from mpc_planner_tpu_torch.experiments.common import card_text

CORRIDOR = ("corridor_benchmark", "--json", "--seeds", "3")
RUNS = (
    ("corridor_table", CORRIDOR + ("--config", "all", "--peds", "4", "8", "12")),
    ("corridor_shmpc", CORRIDOR + ("--config", "shmpc", "--peds", "12")),
    ("corridor_prm", CORRIDOR + ("--config", "tmpc", "--backend", "prm", "--peds", "12")),
    ("corridor_wide", CORRIDOR + ("--config", "tmpc", "--samples-per-class", "250", "--peds", "12")),
    ("shmpc_route", ("shmpc_route",)),
    ("verify_prm_drive", ("verify_prm_drive",)),
    ("guidance_ab", ("guidance_ab",)),
    ("horizon_sweep", ("horizon_sweep",)),
    ("batch_sweep", ("batch_sweep",)),
    ("n30_latency", ("n30_latency",)),
    ("profile_solve", ("profile_solve",)),
    ("fused_rti_check", ("fused_rti_check",)),
    ("scaling_sweep", ("scaling_sweep",)),
) + tuple((f"nvar8_stress_{i}", ("nvar8_stress",)) for i in range(1, 5))
TIMEOUT_S = 900  # one run


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="experiments_out")
    ap.add_argument("--only", nargs="*", default=None, help="run only these NAMEs")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    card = card_text("cuda")
    print(card, flush=True)
    failed = []
    for name, (experiment, *flags) in RUNS:
        if args.only is not None and name not in args.only:
            continue
        argv_run = [sys.executable, "-u", "-m", f"mpc_planner_tpu_torch.experiments.{experiment}", *flags]
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(argv_run, capture_output=True, text=True, timeout=TIMEOUT_S)
            rc, out, err = proc.returncode, proc.stdout, proc.stderr
        except subprocess.TimeoutExpired as e:
            rc, out, err = "timeout", e.stdout or "", e.stderr or ""
            out, err = (x.decode() if isinstance(x, bytes) else x for x in (out, err))
        seconds = time.perf_counter() - t0
        with open(os.path.join(args.out, f"{name}.txt"), "w") as f:
            f.write(f"$ {' '.join(argv_run[2:])}\n[{card}] exit {rc}, {seconds:.1f} s\n{out}\n"
                    f"--- stderr ---\n{err}")
        print(f"{name}: exit {rc}, {seconds:.1f} s", flush=True)
        if rc != 0:
            failed.append(name)
    print(f"failed: {failed}" if failed else "all experiments exited 0")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
