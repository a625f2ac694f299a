"""Stability stress for the nvar=8 (SH-MPC slack model) fused route.

The port's counterpart of experiments/nvar8_stress.py. On the TPU the
nvar=8 kernel flip-flopped across processes between faults, all-NaN
results and correct answers; here it asks whether K3 at nvar=8 gives the
same answer in every fresh process: a batch of BATCH SH-MPC problems
(configuration_safe_horizon at N=20, 8 obstacles) solved on the fused route
(K3, asserted) against the plain route (torch).

Run several times in FRESH processes and compare the digests:
    for i in 1 2 3 4 5 6; do python -m mpc_planner_tpu_torch.experiments.nvar8_stress; done

Prints one line: PASS / NAN / MISMATCH / FAULT, with the max |Z| difference
and a digest of the fused route's Z (sha256 of its float32 bytes).
`--device cpu` runs K3's plain version against the plain route.
"""

from __future__ import annotations

import hashlib
import sys

import numpy as np

from mpc_planner_tpu_torch.experiments.common import (
    build_solver,
    device_parser,
    perturbed_batch,
    resolve_device,
    route_solver,
)

BATCH = 256
RTI = 10
Z_TOL = 1e-2  # absolute, the reference's threshold


def stress(batch=BATCH, rti=RTI, device=None, N=20):
    """(status, the printed line, Z of the fused route as numpy or None)."""
    from mpc_planner_tpu_torch.presets import configuration_safe_horizon, corridor_scene
    from mpc_planner_tpu_torch.utils.config import default_config

    cfg = default_config(N=N).replace(max_obstacles=8)
    model, mgr = configuration_safe_horizon(cfg)
    state, data = corridor_scene(cfg, n_pedestrians=8)
    _, Z0, P, xinit = build_solver(cfg, model, mgr, state, data, "cpu")
    assert model.nvar == 8, model.nvar
    rng = np.random.default_rng(0)
    Z0b, Pb, xb = perturbed_batch(rng, Z0, P, xinit, batch, model.nu, device)

    # Reference: the plain route
    ref = route_solver(model, mgr, cfg, "plain", device).solve_batch(Z0b, Pb, xb, num_iterations=rti)
    Zr = ref.Z.cpu().numpy()

    # Device under test: the fused route
    try:
        solver = route_solver(model, mgr, cfg, "fused", device)
        Zp = solver.solve_batch(Z0b, Pb, xb, num_iterations=rti).Z.cpu().numpy()
    except Exception as exc:  # noqa: BLE001 -- a failed build or launch is the FAULT reading
        return "FAULT", f"FAULT: {str(exc).splitlines()[0][:140]}", None
    digest = hashlib.sha256(np.ascontiguousarray(Zp, np.float32).tobytes()).hexdigest()[:16]
    if not np.all(np.isfinite(Zp)):
        return "NAN", f"NAN: {np.isnan(Zp).mean():.1%} NaN elements (Z {digest})", Zp
    err = float(np.max(np.abs(Zp - Zr)))
    if err > Z_TOL:
        return "MISMATCH", f"MISMATCH: max|Z_fused - Z_plain| = {err:.3e} (Z {digest})", Zp
    return "PASS", f"PASS: max|Z_fused - Z_plain| = {err:.3e} (Z {digest})", Zp


def main(argv=None):
    args = device_parser(__doc__.split("\n\n")[0]).parse_args(argv)
    status, line, _ = stress(device=resolve_device(args.device))
    print(line)
    return {"PASS": 0, "FAULT": 2, "NAN": 3, "MISMATCH": 4}[status]


if __name__ == "__main__":
    sys.exit(main())
