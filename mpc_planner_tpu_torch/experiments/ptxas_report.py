"""Registers, stack frames, spills and static shared memory of every
hand-written kernel, as ptxas reports them (`-Xptxas=-v`, sm_90a), plus the
dynamic shared memory K1 and K3 ask for per block (one warp = one element)
and the blocks per SM that leaves.

    python -m mpc_planner_tpu_torch.experiments.ptxas_report [K1 | K3 | K4 ...]

Builds K1 + K2, K3 for system_jackal("goal"), for the flagship OCP
(configuration_tmpc), for the real Jackal's Gaussian T-MPC, the bicycle,
dingo's point mass and rosnavigation's slack T-MPC, and K4 from the
sources, with the build's output captured, and prints the lines that name
a kernel or a noinline function. With arguments, only the libraries whose
label starts with one of them ("K1" alone takes about a minute).
Needs nvcc (the machine with the card); each library must not be built yet
in this process, or ninja has nothing to report.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
import tempfile


def _captured(fn, *args):
    """fn(*args) with file descriptors 1 and 2 sent to a file; its text."""
    sys.stdout.flush()
    with tempfile.TemporaryFile(mode="w+b") as f:
        saved = os.dup(1), os.dup(2)
        os.dup2(f.fileno(), 1)
        os.dup2(f.fileno(), 2)
        try:
            fn(*args)
        finally:
            os.dup2(saved[0], 1)
            os.dup2(saved[1], 2)
            os.close(saved[0])
            os.close(saved[1])
        f.seek(0)
        return f.read().decode(errors="replace")


def _demangle(text: str) -> str:
    try:
        return subprocess.run(["c++filt"], input=text, capture_output=True, text=True,
                              timeout=60).stdout or text
    except OSError:
        return text


def summarize(log: str):
    """[function, registers (None for a noinline function: it shares its
    caller's), stack bytes, spill stores, spill loads, static shared bytes]
    for every function ptxas compiled."""
    rows, name = [], None
    for line in _demangle(log).splitlines():
        m = re.search(r"Function properties for '?(.+?)'?\s*$", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            rows.append([name, None, *map(int, m.groups()), 0])
            name = None
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and rows:
            rows[-1][1], rows[-1][5] = int(m.group(1)), int(m.group(2) or 0)
    return rows


def main():
    from mpc_planner_tpu_torch import presets
    from mpc_planner_tpu_torch.experiments import riccati_probe
    from mpc_planner_tpu_torch.ops import cuda_qp, cuda_rti
    from mpc_planner_tpu_torch.ops.stage_codegen import StageCode
    from mpc_planner_tpu_torch.solver.ocp import OCP
    from mpc_planner_tpu_torch.utils.config import default_config

    cfg, model, modules = presets.system_jackal("goal", N=30)
    goal = StageCode(OCP(model, modules, cfg))
    c20 = default_config(N=20)
    flagship = StageCode(OCP(*presets.configuration_tmpc(c20), c20))
    c30 = default_config(N=30)
    others = {"jackal tmpc (Gaussian)": presets.system_jackal("tmpc"),
              "bicycle": (c30, *presets.configuration_bicycle(c30)),
              "dingo lmpcc (point mass)": presets.system_dingo("lmpcc"),
              "rosnavigation tmpc (slack, decomp)": presets.system_rosnavigation("tmpc")}
    builds = [("K1 + K2", cuda_qp.load_kernels, (True,)),
              ("K3 goal", cuda_rti.load_rti, (goal, True)),
              ("K3 flagship", cuda_rti.load_rti, (flagship, True)),
              *((f"K3 {name}", cuda_rti.load_rti, (StageCode(OCP(m, mods, c)), True))
                for name, (c, m, mods) in others.items()),
              ("K4", riccati_probe.load_probe, (True,))]
    only = sys.argv[1:]
    for label, fn, args in builds:
        if only and not label.startswith(tuple(only)):
            continue
        print(f"== {label}")
        for name, regs, stack, stores, loads, smem in summarize(_captured(fn, *args)):
            if len(name) > 110:
                name = name[:107] + "..."
            regs = "   -" if regs is None else f"{regs:4d}"
            print(f"{regs} registers, {stack:5d} B stack, spill {stores:5d} B stores / {loads:5d} B "
                  f"loads, {smem:5d} B static smem: {name}")
    ext = cuda_qp.load_kernels()
    print("== dynamic shared memory per block (one warp, one element), and the blocks the card "
          "holds at once by it (registers: 65,536 an SM)")
    for label, N, nu, nx, nh in (("flagship N=20", 20, 2, 5, 24), ("flagship N=30", 30, 2, 5, 24),
                                 ("goal N=30", 30, 2, 5, 12), ("bicycle N=30", 30, 3, 6, 12),
                                 ("dingo lmpcc N=30", 30, 2, 4, 24),
                                 ("rosnavigation tmpc N=20", 20, 3, 5, 36)):
        for staged in (False, True):
            for mirror in (False, True):
                nbytes = ext.qp_shared_bytes(N, nu, nx, nh, staged, mirror)
                print(f"{label}, QP data {'staged in shared memory' if staged else 'in global memory'}"
                      f"{', MIRROR inside' if mirror else ''}: {nbytes} B a block, "
                      f"{ext.qp_resident_blocks(nbytes)} blocks resident")


if __name__ == "__main__":
    main()
