"""T-MPC++ guidance constraints: the flagship module.

Counterpart of mpc_planner_tpu/modules/guidance_constraints.py. Ref
symbolic half mpc_planner_modules/scripts/guidance_constraints.py:23-110
(one halfspace per obstacle w.r.t. the robot point + an embedded safety
submodule, default ellipsoid), runtime half
mpc_planner_modules/src/guidance_constraints.cpp (guidance PRM :106,
homotopy-preserving planner mapping :192-250, parallel solves :279,
consistency bonus :358-359, best-feasible selection :416-434).

Where the reference copies its solver `n_paths+1` times and runs OpenMP
threads, the batch axis of one SQP solve carries every planner: each batch
element gets its own warm start (from a guidance trajectory) and its own
halfspace parameters (linearized around that trajectory). One device step
per cycle (`_fused_step`) assembles the halfspaces, solves the batch on the
solver's device (K1+K2, or K3 with `solver.rti_fused="on"`) and takes the
consistency-weighted argmin; the host receives ONE packed vector per
dispatch, and the duals carried to the next cycle stay on the device.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from mpc_planner_tpu_torch.modules.base import BoundModel, ConstraintModule
from mpc_planner_tpu_torch.modules.ellipsoid_constraints import EllipsoidConstraintModule
from mpc_planner_tpu_torch.parameters import ParameterBlock, ParameterRegistry
from mpc_planner_tpu_torch.solver.warmstart import clip_to_bounds


class GuidanceConstraintModule(ConstraintModule):
    module_name = "GuidanceConstraints"
    description = "T-MPC++: parallel homotopy-class MPC over a batch axis"

    def __init__(self, cfg, constraint_submodule=None):
        self.cfg = cfg
        self.max_obstacles = cfg.max_obstacles
        self.n_other_halfspaces = cfg.linearized_add_halfspaces
        self.nh_own = self.max_obstacles + self.n_other_halfspaces
        submodule_cls = constraint_submodule or EllipsoidConstraintModule
        self.submodule = submodule_cls(cfg)
        self.use_tmpc_pp = cfg.t_mpc.use_tmpc_pp
        self.enable_constraints = cfg.t_mpc.enable_constraints
        self.n_planners = (
            cfg.t_mpc.n_paths * max(1, cfg.t_mpc.samples_per_class)
            + (1 if cfg.t_mpc.braking_class else 0)
            + (1 if self.use_tmpc_pp else 0)
        )
        self.guidance = None  # GuidancePlanner, made at the first update
        self._selected_planner = -1
        self._trajectories = []
        self._planner = None
        # (lam_l, lam_u, ok) carried across cycles, kept on the solver's
        # device: only the packed selection result crosses to the host.
        self._prev_duals = None
        self._bundle_idx = None  # (a1, a2, b) parameter indices on the device
        self._last_batch_Z = None  # [B, N+1, nvar] on the device

    def define_parameters(self, params: ParameterRegistry) -> None:
        # Own halfspaces (ref guidance_constraints.py:70-80): names WITHOUT
        # a disc prefix, as in the reference.
        for i in range(self.nh_own):
            params.add(f"lin_constraint_{i}_a1", bundle_name="lin_constraint_a1")
            params.add(f"lin_constraint_{i}_a2", bundle_name="lin_constraint_a2")
            params.add(f"lin_constraint_{i}_b", bundle_name="lin_constraint_b")
        self.submodule.define_parameters(params)

    def lower_bounds(self):
        return [-np.inf] * self.nh_own + list(self.submodule.lower_bounds())

    def upper_bounds(self):
        return [0.0] * self.nh_own + list(self.submodule.upper_bounds())

    def constraints(self, model: BoundModel, params: ParameterRegistry, cfg, stage_idx: int):
        pos_x, pos_y = model.get("x"), model.get("y")
        out = []
        for i in range(self.nh_own):
            a1 = params.get(f"lin_constraint_{i}_a1")
            a2 = params.get(f"lin_constraint_{i}_a2")
            b = params.get(f"lin_constraint_{i}_b")
            out.append(a1 * pos_x + a2 * pos_y - b)
        out.extend(self.submodule.constraints(model, params, cfg, stage_idx))
        return out

    # -- host half ---------------------------------------------------------
    def attach(self, planner) -> None:
        """Called by the Planner: gives the module the batched solver
        (the reference passes a shared Solver into each module's ctor)."""
        self._planner = planner

    def update(self, state, data, module_data) -> None:
        """Run the guidance layer (ref guidance_constraints.cpp:100-130)."""
        self.submodule.update(state, data, module_data)
        self._trajectories = []
        if module_data.path is None or data.obstacle_block is None:
            return
        if self.guidance is None:
            from mpc_planner_tpu_torch.guidance import make_guidance_planner

            device = None if self._planner is None else self._planner.solver.device
            self.guidance = make_guidance_planner(self.cfg, device=device)
        v_ref = self.cfg.weights.get("reference_velocity", 1.0)
        with self._scope("guidance_update"):
            self._trajectories = self.guidance.update(
                state, module_data.path, data.obstacle_block, state.get("spline"), v_ref)

    def _scope(self, name: str):
        if self._planner is None:
            return contextlib.nullcontext()
        return self._planner.profiler.scope(name)

    def optimize(self, state, data, module_data):
        """Batched parallel optimize + selection (ref guidance_constraints.
        cpp:264-434; the OpenMP loop :279 is one batched solve)."""
        planner = self._planner
        if planner is None or not self._trajectories:
            return None  # fall through to the default solver

        cfg = self.cfg
        model = planner.model
        solver = planner.solver
        dev = solver.device
        N = cfg.N
        B = self.n_planners
        nvar = model.nvar
        base_P = module_data.pblock.data  # [N+1, npar] main fill
        Z_main = module_data.warmstart
        blk = data.obstacle_block

        trajs = list(self._trajectories)
        n_guided = B - (1 if self.use_tmpc_pp else 0)
        while len(trajs) < n_guided:  # pad with duplicates: B stays fixed
            trajs.append(trajs[-1])
        trajs = trajs[:n_guided]

        with self._scope("tmpc_host_assemble"):
            Z0 = np.zeros((B, N + 1, nvar), dtype=np.float32)
            Z0[: len(trajs)] = self._warmstarts_from_guidance(model, trajs, Z_main)
            # Braking class: safety submodule only, no topology halfspaces
            # (a stop-in-lane plan stays feasible when every side is blocked).
            guided = np.zeros(B, dtype=bool)
            guided[: len(trajs)] = [not t.braking for t in trajs]
            if not self.enable_constraints:
                guided[:] = False
            if self.use_tmpc_pp:
                # T-MPC++: the non-guided planner with the main warmstart and
                # no homotopy constraints (ref :286-298 "original planner")
                Z0[B - 1] = Z_main
                guided[B - 1] = False
            # Halfspace linearization points: the class representative for
            # samples_per_class variants, the trajectory itself otherwise.
            pos_all = np.stack(
                [t.positions if t.base_positions is None else t.base_positions for t in trajs]
                + [Z_main[:, [model.index("x"), model.index("y")]]] * (B - len(trajs)),
                axis=0,
            ).astype(np.float32)
            xinit = np.tile(module_data.xinit[None], (B, 1)).astype(np.float32)
            # Consistency bonus for the previously selected class (ref
            # :358-359). The braking class is exempt, and competes only when
            # nothing else is feasible (the selection below).
            consistency = np.ones(B, np.float32)
            braking_mask = np.zeros(B, dtype=bool)
            for i, traj in enumerate(trajs):
                braking_mask[i] = traj.braking
                if traj.previously_selected and not braking_mask[i]:
                    consistency[i] = cfg.t_mpc.selection_weight_consistency

            def on_dev(x, dtype=torch.float32):
                return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

            inputs = dict(
                base_P=on_dev(np.asarray(base_P, np.float32)), pos=on_dev(pos_all),
                obst=on_dev(np.asarray(blk.pred_position[:, : N - 1], np.float32)),
                guided=on_dev(guided, torch.bool),
                rr=torch.tensor(cfg.robot_radius, dtype=torch.float32, device=dev),
                Z0=on_dev(Z0), xinit=on_dev(xinit), consistency=on_dev(consistency),
                braking=on_dev(braking_mask, torch.bool))

        # Cross-cycle dual warm start: last cycle's converged QP duals feed
        # this cycle's first QP (planner i keeps its class between cycles).
        warm = self._prev_duals
        if warm is not None and warm[0].shape[0] != B:
            warm = None
        n_iter = int(module_data.num_iterations)
        reg = module_data.pblock.registry

        with self._scope("tmpc_dispatch_solve_pull"):
            packed_d, Zall, ll, lu = self._fused_step(reg, n_iter, warm, **inputs)
            # THE one device -> host copy of the dispatch
            Z_best, best, found, exit_codes, pobj, qp_mu = self._unpack(packed_d.cpu().numpy(), B)
        # stays on the device: read by the next cycle's solve only
        self._prev_duals = (ll, lu, torch.as_tensor(exit_codes == 1, device=dev))

        # In-cycle escalation of hard warm-dual failures AND soft stalls
        # (feasible, barrier mu above qp_mu_stall): one more dispatch at the
        # full IP budget, on flagged cycles only (solve_batch's semantics).
        stalled_f = (exit_codes == 1) & (qp_mu > solver.qp_mu_stall)
        if solver.qp_retry_cold and ((exit_codes == -1) | stalled_f).any():
            # Cold cycles escalate every flagged element; warm cycles only
            # those whose carried duals were applied (ok=False elements
            # already solved cold inside the warm dispatch).
            applied = np.ones(B, bool) if warm is None else warm[2].cpu().numpy()
            failed = (exit_codes == -1) & applied
            stalled = stalled_f & applied
            if (failed | stalled).any():
                with self._scope("tmpc_escalation"):
                    packed_c, Zall_c, ll_c, lu_c = self._fused_step(
                        reg, n_iter, None, escalated=True, **inputs)
                    _, _, _, codes_cold, pobj_cold, _ = self._unpack(packed_c.cpu().numpy(), B)
                adopt = (failed & (codes_cold > exit_codes)) | (stalled & (codes_cold == 1))
                if adopt.any():
                    exit_codes = np.where(adopt, codes_cold, exit_codes)
                    pobj = np.where(adopt, pobj_cold, pobj)
                    mm = torch.as_tensor(adopt, device=dev)[:, None, None]
                    Zall = torch.where(mm, Zall_c, Zall)
                    self._prev_duals = (torch.where(mm, ll_c, ll), torch.where(mm, lu_c, lu),
                                        torch.as_tensor(exit_codes == 1, device=dev))
                    # select again on the merged result (host, tiny arrays)
                    feas = exit_codes == 1
                    if (feas & ~braking_mask).any():
                        feas = feas & ~braking_mask
                    masked = np.where(feas, pobj * consistency, np.inf)
                    best = int(np.argmin(masked))
                    found = bool(np.isfinite(masked[best]))
                    Z_best = Zall[best].cpu().numpy()

        if not found:
            self.guidance.override_selected(None)
            return {"Z": Z_main, "exit_code": int(exit_codes[0]), "pobj": float("inf")}

        self._selected_planner = best
        feas_eff = exit_codes == 1
        if (feas_eff & ~braking_mask).any():
            feas_eff = feas_eff & ~braking_mask
        self._last_n_feasible = int(feas_eff.sum())
        self._last_pobj_best = float(pobj[best] * consistency[best])
        self._last_batch_Z = Zall
        self.guidance.override_selected(trajs[best] if best < len(trajs) else None)
        return {"Z": Z_best, "exit_code": 1, "pobj": float(pobj[best]), "batch": True,
                "selected": best}

    def _unpack(self, packed: np.ndarray, B: int):
        """(Z of the winner, its index, found, exit codes, pobj, final mu)
        of one packed result vector."""
        N, nvar = self.cfg.N, self._planner.model.nvar
        nz = (N + 1) * nvar
        return (packed[:nz].reshape(N + 1, nvar), int(packed[-2]), bool(packed[-1] > 0.5),
                packed[nz:nz + B].astype(np.int32), packed[nz + B:nz + 2 * B].astype(float),
                packed[nz + 2 * B:nz + 3 * B].astype(float))

    def _fused_step(self, reg, n_iter: int, warm, *, base_P, pos, obst, guided, rr, Z0, xinit,
                    consistency, braking, escalated: bool = False):
        """The device step of one control cycle (the reference's one jitted
        program, mpc_planner_tpu/modules/guidance_constraints.py:335-413),
        on the solver's device:

        1. per-planner parameter assembly: broadcast the shared base fill
           and linearize the separating halfspaces around each guidance
           trajectory (LinearizedConstraints topology mode, linearized_
           constraints.cpp:43-47, 85-105: radius 1e-3, robot point);
           non-guided rows (braking / the T-MPC++ planner) get the inactive
           fill a=0, b=100; the terminal row copies stage N-1;
        2. the batched SQP-RTI solve (`SQPSolver.batch_impl`, with the
           carried duals when `warm` is given);
        3. the T-MPC selection: argmin of the consistency-weighted cost over
           the feasible planners, braking planners competing only when
           nothing else is feasible.

        Returns (packed, Z of every planner, lam_l, lam_u): `packed` is one
        f32 vector [Z of the winner, exit codes, pobj, qp_mu, best, found].
        """
        N = self.cfg.N
        B = Z0.shape[0]
        n_obs = obst.shape[0]
        if self._bundle_idx is None or self._bundle_idx[0].device != base_P.device:
            self._bundle_idx = tuple(
                torch.as_tensor(reg.bundle_indices(f"lin_constraint_{c}")[:n_obs],
                                dtype=torch.long, device=base_P.device)
                for c in ("a1", "a2", "b"))
        a1_idx, a2_idx, b_idx = self._bundle_idx

        p = pos[:, 1:N]  # [B, N-1, 2] stages 1..N-1
        diff = obst[None] - p[:, None, :, :]  # [B, M, N-1, 2]
        dist = torch.clamp(torch.sqrt((diff * diff).sum(-1)), min=1e-9)
        a1 = (diff[..., 0] / dist).transpose(1, 2)  # [B, N-1, M]
        a2 = (diff[..., 1] / dist).transpose(1, 2)
        ox = obst[..., 0].T[None]  # [1, N-1, M]
        oy = obst[..., 1].T[None]
        b = a1 * ox + a2 * oy - (1e-3 + rr)
        gm = guided[:, None, None]
        a1 = torch.where(gm, a1, 0.0)
        a2 = torch.where(gm, a2, 0.0)
        b = torch.where(gm, b, 100.0)
        P = base_P[None].expand((B,) + tuple(base_P.shape)).clone()
        P[:, 1:N, a1_idx] = a1
        P[:, 1:N, a2_idx] = a2
        P[:, 1:N, b_idx] = b
        P[:, N] = P[:, N - 1]

        res = self._planner.solver.batch_impl(Z0, P, xinit, n_iter, warm0=warm,
                                              escalated=escalated)

        feasible = res.exit_code == 1
        nb = feasible & ~braking
        feas_eff = torch.where(nb.any(), nb, feasible)
        masked = torch.where(feas_eff, res.pobj * consistency, math.inf)
        best = torch.argmin(masked)
        found = torch.isfinite(masked[best])
        packed = torch.cat([
            res.Z[best].reshape(-1),
            res.exit_code.to(torch.float32),
            res.pobj,
            res.qp_mu.to(torch.float32),
            torch.stack([best.to(torch.float32), found.to(torch.float32)]),
        ])
        return packed, res.Z, res.lam_l, res.lam_u

    def _warmstarts_from_guidance(self, model, trajs, Z_main) -> np.ndarray:
        """initializeSolverWithGuidance (ref :390-414), vectorized over the
        trajectory batch: x, y from the guidance, psi from its direction, v
        from its spacing, inputs by finite differences, so every warmstart
        is close to dynamically consistent."""
        N = self.cfg.N
        dt = self.cfg.dt
        B = len(trajs)
        Z = np.broadcast_to(np.asarray(Z_main, dtype=float), (B,) + Z_main.shape).copy()
        pos = np.stack([t.positions for t in trajs], axis=0)  # [B, N+1, 2]
        d = np.diff(pos, axis=1)  # [B, N, 2]
        step = np.linalg.norm(d, axis=-1)  # [B, N]
        ang = np.arctan2(d[..., 1], d[..., 0])
        # psi from direction; carry the previous value through ~zero steps
        psi = np.empty((B, N + 1))
        psi[:, 0] = Z_main[0, model.index("psi")] if "psi" in model.states else 0.0
        for k in range(1, N + 1):
            psi[:, k] = np.where(step[:, k - 1] > 1e-3, ang[:, k - 1], psi[:, k - 1])
        speed = np.concatenate([step / dt, step[:, -1:] / dt], axis=1)

        Z[:, :, model.index("x")] = pos[..., 0]
        Z[:, :, model.index("y")] = pos[..., 1]
        try:
            Z[:, :, model.index("psi")] = psi
            Z[:, :, model.index("v")] = speed
        except KeyError:
            pass
        try:
            Z[:, :, model.index("spline")] = np.stack([t.s for t in trajs], axis=0)
        except KeyError:
            pass
        # Inputs by finite differences
        try:
            Z[:, :-1, model.index("a")] = np.diff(speed, axis=1) / dt
            Z[:, -1, model.index("a")] = 0.0
        except KeyError:
            pass
        try:
            dpsi = np.mod(np.diff(psi, axis=1) + np.pi, 2 * np.pi) - np.pi
            Z[:, :-1, model.index("w")] = dpsi / dt
            Z[:, -1, model.index("w")] = 0.0
        except KeyError:
            pass
        # Holonomic (point-mass) models: velocity/acceleration components
        if "vx" in model.states:
            vel = np.concatenate([d / dt, d[:, -1:] / dt], axis=1)  # [B, N+1, 2]
            Z[:, :, model.index("vx")] = vel[..., 0]
            Z[:, :, model.index("vy")] = vel[..., 1]
            acc = np.diff(vel, axis=1) / dt
            Z[:, :-1, model.index("ax")] = acc[..., 0]
            Z[:, :-1, model.index("ay")] = acc[..., 1]
            Z[:, -1, model.index("ax")] = 0.0
            Z[:, -1, model.index("ay")] = 0.0
        return clip_to_bounds(model, Z)

    def save_data(self, record: dict) -> None:
        """Selection metrics per cycle (ref guidance_constraints.cpp
        saveData: best planner id, objective)."""
        record["guidance_selected_planner"] = self._selected_planner
        record["guidance_n_planners"] = self.n_planners
        record["guidance_n_feasible"] = getattr(self, "_last_n_feasible", 0)
        record["guidance_best_objective"] = getattr(self, "_last_pobj_best", float("inf"))
        self.submodule.save_data(record)

    def is_objective_reached(self, state, data) -> bool:
        return self.submodule.is_objective_reached(state, data)

    def reset(self) -> None:
        self._trajectories = []
        self._prev_duals = None
        if self.guidance is not None:
            self.guidance.reset()
        self.submodule.reset()

    def set_parameters(self, data, module_data, pblock: ParameterBlock) -> None:
        # Default fill: inactive own halfspaces + submodule parameters.
        n_stages = pblock.n_stages
        pblock.set_bundle_all_stages("lin_constraint_a1", np.zeros((n_stages, self.nh_own)))
        pblock.set_bundle_all_stages("lin_constraint_a2", np.zeros((n_stages, self.nh_own)))
        pblock.set_bundle_all_stages("lin_constraint_b", np.full((n_stages, self.nh_own), 100.0))
        self.submodule.set_parameters(data, module_data, pblock)

    def is_data_ready(self, data):
        return self.submodule.is_data_ready(data)

    def on_data_received(self, data, data_name: str) -> None:
        self.submodule.on_data_received(data, data_name)
