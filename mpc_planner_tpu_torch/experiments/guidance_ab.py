"""Guidance backend A/B: homotopy-class recall on dense scenes.

The port's counterpart of experiments/guidance_ab.py (the same flags,
`--cpu` becoming `--device cpu`; the same rows and JSON keys). For each
random dense corridor scene every backend produces its guidance
trajectories and we measure:

  - classes/scene: distinct passing-side signatures produced (diversity);
  - recall vs union: fraction of the UNION of all backends' signatures
    on that scene this backend found (backend-relative completeness —
    no tractable ground truth exists for (x, y, t) homotopy classes);
  - collision-free: fraction of returned trajectories keeping clear of
    every constant-velocity prediction (a class is only useful if its
    representative is roughly trackable);
  - ms/cycle: host time per guidance update, ended by a device sync (the
    sampled backend's sweep runs on the card).

Signature = per-tracked-obstacle passing side at closest approach (the
winding/H-signature collapse of guidance/homotopy.py), over obstacles
within 3 m of the trajectory. The lateral and prm backends run on the host
and draw what the reference draws; the sampled one draws from a torch
generator, so its classes are its own.

    python -m mpc_planner_tpu_torch.experiments.guidance_ab [--scenes 20] [--peds 12] [--device cpu]

Prints one markdown table + one JSON line per backend.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

from mpc_planner_tpu_torch.experiments.common import device_parser, resolve_device, timed

BACKENDS = ("lateral", "prm", "sampled")


def prepared_scene(seed, peds):
    """corridor_scene + module update_all -> (cfg, state, data, md)."""
    from mpc_planner_tpu_torch.presets import configuration_tmpc, corridor_scene
    from mpc_planner_tpu_torch.solver.ocp import OCP
    from mpc_planner_tpu_torch.solver.warmstart import initialize_with_state
    from mpc_planner_tpu_torch.types import ModuleData
    from mpc_planner_tpu_torch.utils.config import default_config

    cfg = default_config(N=20).replace(max_obstacles=peds)
    model, mgr = configuration_tmpc(cfg)
    state, data = corridor_scene(cfg, n_pedestrians=peds, seed=seed)
    OCP(model, mgr, cfg)  # binds modules' parameter registries
    md = ModuleData()
    mgr.on_data_received(data, "reference_path")
    mgr.on_data_received(data, "dynamic obstacles")
    Z0 = initialize_with_state(model, cfg.N, state)
    md.warmstart = Z0
    md.warmstart_xy = Z0[:, [model.index("x"), model.index("y")]]
    md.warmstart_psi = Z0[:, model.index("psi")]
    if "spline" in model.states:
        md.warmstart_spline = Z0[:, model.index("spline")]
    mgr.update_all(state, data, md)
    return cfg, state, data, md


def _predictions(blk):
    return np.concatenate([blk.position[:, None, :], blk.pred_position], axis=1)  # [M, N+1, 2]


def signature(positions, blk):
    sig = []
    pred = _predictions(blk)
    K = min(len(positions), pred.shape[1])
    for m in range(pred.shape[0]):
        rel = positions[:K] - pred[m, :K]
        d = np.linalg.norm(rel, axis=1)
        k = int(np.argmin(d))
        sig.append(0 if d[k] > 3.0 else (1 if rel[k, 1] > 0 else -1))
    return tuple(sig)


def collision_free(positions, blk, robot_r):
    pred = _predictions(blk)
    K = min(len(positions), pred.shape[1])
    for m in range(pred.shape[0]):
        d = np.linalg.norm(positions[:K] - pred[m, :K], axis=1)
        if np.any(d < robot_r + blk.radius[m]):
            return False
    return True


def run(scenes, peds, device):
    """Every backend on `scenes` scenes of `peds` pedestrians; prints the
    table and the JSON lines and returns the rows (dicts)."""
    from mpc_planner_tpu_torch.guidance import make_guidance_planner

    stats = {b: {"sigs": [], "n_traj": 0, "free": 0, "ms": 0.0} for b in BACKENDS}
    unions = []
    for scene_i in range(scenes):
        cfg, state, data, md = prepared_scene(scene_i, peds)
        blk = data.obstacle_block
        v_ref = cfg.weights.get("reference_velocity", 1.0)
        scene_sigs = {}
        for b in BACKENDS:
            cfg_b = cfg.replace(t_mpc=dataclasses.replace(cfg.t_mpc, guidance_backend=b))
            g = make_guidance_planner(cfg_b, device)
            trajs, seconds = timed(
                lambda: g.update(state, md.path, blk, float(state.get("spline")), v_ref), device)
            if scene_i:  # the first scene pays the sampled sweep's first launches
                stats[b]["ms"] += seconds * 1e3
            sigs = set()
            for t in trajs:
                if getattr(t, "braking", False):
                    continue
                pos = np.asarray(t.positions)
                sigs.add(signature(pos, blk))
                stats[b]["n_traj"] += 1
                stats[b]["free"] += int(collision_free(pos, blk, cfg.robot_radius))
            scene_sigs[b] = sigs
            stats[b]["sigs"].append(sigs)
        unions.append(set().union(*scene_sigs.values()))

    print(f"# scenes={scenes} peds={peds}")
    print("| backend | classes/scene | recall vs union | collision-free | ms/cycle |")
    print("|---|---|---|---|---|")
    rows = []
    for b in BACKENDS:
        d = stats[b]
        n_classes = np.mean([len(s) for s in d["sigs"]])
        recalls = [len(s & u) / max(len(u), 1) for s, u in zip(d["sigs"], unions)]
        free = d["free"] / max(d["n_traj"], 1)
        ms = d["ms"] / max(scenes - 1, 1)
        row = {
            "backend": b,
            "classes_per_scene": round(float(n_classes), 2),
            "recall_vs_union": round(float(np.mean(recalls)), 3),
            "collision_free_frac": round(float(free), 3),
            "ms_per_cycle": round(float(ms), 2),
        }
        print(f"| {b} | {row['classes_per_scene']} | {row['recall_vs_union']} "
              f"| {row['collision_free_frac']} | {row['ms_per_cycle']} |")
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def main(argv=None):
    ap = device_parser(__doc__.split("\n\n")[0])
    ap.add_argument("--scenes", type=int, default=20)
    ap.add_argument("--peds", type=int, default=12)
    args = ap.parse_args(argv)
    run(args.scenes, args.peds, resolve_device(args.device))


if __name__ == "__main__":
    main()
