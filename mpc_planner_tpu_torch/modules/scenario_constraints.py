"""Scenario-based constraints: SH-MPC.

Counterpart of mpc_planner_tpu/modules/scenario_constraints.py. Ref
symbolic half mpc_planner_modules/scripts/scenario_constraints.py:14-94
(24 halfspaces x n_discs with a slack), runtime half
mpc_planner_modules/src/scenario_constraints.cpp + the external
scenario_module: per-solver scenario draws, support-subsample selection,
parallel solves, best-cost selection.

The `parallel_solvers` scenario solvers ride the batch axis of one SQP
solve. One device step per cycle (`_fused_step`, on the solver's device)
turns each solver's draws into separating halfspaces, keeps the tightest
`n_constraints` per stage, assembles the parameters, solves the batch (K3,
or K1 with `rti_fused="off"`), takes the best-cost feasible solver and the
scenario-theory accounting (support counts from the QP duals, the pruning
check, the risk certificate of modules/scenario_theory.py); the host
receives one packed vector, and the duals carried to the next cycle stay
on the device.

The draws come from a torch.Generator seeded from the module's sample seed
(`draw`): they cannot equal the JAX package's `jax.random` draws, so the
tests hand the JAX draws to this module (interop.scenario_draws_to_torch)
and hold everything downstream of the draw to the reference. Kept as the
reference has them (ROADMAP.md, queue 3): the certificate omits stage N,
support is counted per stage, and the terminal slack is frozen.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from mpc_planner_tpu_torch.modules.base import BoundModel, ConstraintModule
from mpc_planner_tpu_torch.modules.scenario_theory import epsilon_posterior_torch, sample_size
from mpc_planner_tpu_torch.parameters import ParameterBlock, ParameterRegistry


def _scenario_samples(noise, mode_idx, position, angle, major, minor):
    """Sampled obstacle positions (sx, sy), each [B, N-1, S, M]: standard
    normal noise [B, S, M, N-1, 2] along a prediction's major and minor axes,
    rotated by its angle and added to its mean. Single mode (`mode_idx`
    None): position [M, N-1, 2], angle/major/minor [M, N-1]. A mixture:
    sample (b, s) of obstacle m follows mode mode_idx [B, S, M] of the
    [M, K, N-1(, 2)] arrays, with the noise in that mode's frame."""
    if mode_idx is None:
        def pick(a):  # [M, N-1] -> [N-1, 1, M]
            return a.T[:, None, :]
    else:
        rows = torch.arange(major.shape[0], device=noise.device)

        def pick(a):  # [M, K, N-1] -> [B, N-1, S, M]
            return a[rows, mode_idx].permute(0, 3, 1, 2)
    nz = noise.permute(0, 3, 4, 1, 2)  # [B, N-1, 2, S, M]
    ang = pick(angle)
    cos_a, sin_a = torch.cos(ang), torch.sin(ang)
    ex = nz[:, :, 0] * pick(major)
    ey = nz[:, :, 1] * pick(minor)
    sx = pick(position[..., 0]) + (cos_a * ex - sin_a * ey)
    sy = pick(position[..., 1]) + (sin_a * ex + cos_a * ey)
    return sx, sy


def _halfspaces(sx, sy, radius, p_ws, robot_r):
    """Separating halfspaces of sampled positions [B, N-1, S, M] against the
    warm start p_ws [N-1, 2] (stages 1..N-1): (a1, a2, b, margin), each
    [B, N-1, S*M], margin the warm start's signed intrusion (radius minus
    distance)."""
    px = p_ws[:, 0, None, None]
    py = p_ws[:, 1, None, None]
    diff_x = sx - px
    diff_y = sy - py
    dist = torch.clamp(torch.sqrt(diff_x * diff_x + diff_y * diff_y), min=1e-9)
    a1 = diff_x / dist
    a2 = diff_y / dist
    del diff_x, diff_y, dist
    b = a1 * sx + a2 * sy - (radius + robot_r)
    margin = a1 * px + a2 * py - b
    B, n, S, M = a1.shape
    return tuple(t.reshape(B, n, S * M) for t in (a1, a2, b, margin))


def _device_scenario_halfspaces(noise, pred_position, pred_angle, pred_major, pred_minor,
                                radius, p_ws, robot_r):
    """Scenario halfspaces of B solvers (ref :23-56, vmapped there).

    noise [B, S, M, N-1, 2] standard normal; pred_position [M, N-1, 2],
    pred_angle/major/minor [M, N-1]; radius [M]; p_ws [N-1, 2] the warm
    start's positions at stages 1..N-1. Returns (a1, a2, b, margin), each
    [B, N-1, S*M] (stage-major: the reference's [S*M, N-1] transposed): row
    s*M + m is obstacle m's halfspace in joint scenario s."""
    sx, sy = _scenario_samples(noise, None, pred_position, pred_angle, pred_major, pred_minor)
    return _halfspaces(sx, sy, radius, p_ws, robot_r)


def _device_scenario_halfspaces_mm(noise, mode_idx, modes_position, modes_angle, modes_major,
                                   modes_minor, radius, p_ws, robot_r):
    """Multi-modal variant (ref :59-98): sample (b, s) of obstacle m follows
    mode mode_idx [B, S, M] of its mixture, the noise rotated into that
    mode's frame; modes_* [M, K, N-1(, 2)]. Otherwise as
    `_device_scenario_halfspaces`."""
    sx, sy = _scenario_samples(noise, mode_idx, modes_position, modes_angle, modes_major,
                               modes_minor)
    return _halfspaces(sx, sy, radius, p_ws, robot_r)


def _select_tightest(a1, a2, b, margin, n_constraints: int):
    """The `n_constraints` halfspaces with the largest margin (the tightest)
    per stage, in `lax.top_k`'s order (ref :101-111): largest first, equal
    margins by the lower row index. Inputs [..., S*M]; returns (a1, a2, b,
    idx), each [..., n_constraints], idx the kept rows.

    The order is made exact by one unique int64 key per row: the margin's
    bits, mapped so that integer order is float order, above the reversed
    row index. torch.topk on unique keys has one answer."""
    L = margin.shape[-1]
    bits = margin.contiguous().view(torch.int32)
    key = torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF).to(torch.int64)
    key = (key << 32) | (L - 1 - torch.arange(L, device=margin.device))
    idx = torch.topk(key, n_constraints, dim=-1).indices
    del key
    return (torch.gather(a1, -1, idx), torch.gather(a2, -1, idx), torch.gather(b, -1, idx), idx)


class ScenarioConstraintModule(ConstraintModule):
    module_name = "ScenarioConstraints"
    description = "Scenario-based obstacle avoidance under motion uncertainty"

    #: QP dual above this counts the halfspace as active (support member).
    ACTIVE_DUAL_TOL = 1e-6
    #: A discarded sample's violation beyond this at the returned solution
    #: means the top-k pruning was not exact: the certificate is invalid.
    PRUNE_TOL = 1e-4

    def __init__(self, cfg):
        self.cfg = cfg
        self.n_discs = cfg.n_discs
        sc = cfg.scenario_constraints
        self.n_constraints = sc.n_constraints
        self.num_constraints = self.n_constraints * self.n_discs
        self.use_slack = True
        # The configured risk governs the draw unless n_samples is given; the
        # confidence is split over the solvers and the constrained stages.
        self._beta = sc.confidence
        self._beta_stage = self._beta / (sc.parallel_solvers * max(cfg.N - 1, 1))
        if sc.n_samples is None:
            self.n_samples = sample_size(cfg.probabilistic.risk, self._beta_stage, sc.support_bound)
        else:
            self.n_samples = int(sc.n_samples)
        self._planner = None
        self._sample_seed = 0
        # (lam_l, lam_u, ok) carried across cycles, kept on the solver's device
        self._prev_duals = None
        self._bundle_idx = None  # (a1, a2, b) parameter indices on the device

    def define_parameters(self, params: ParameterRegistry) -> None:
        for d in range(self.n_discs):
            params.add(f"ego_disc_{d}_offset", bundle_name="ego_disc_offset")
            for i in range(self.n_constraints):
                params.add(f"disc_{d}_scenario_constraint_{i}_a1", bundle_name="scenario_a1")
                params.add(f"disc_{d}_scenario_constraint_{i}_a2", bundle_name="scenario_a2")
                params.add(f"disc_{d}_scenario_constraint_{i}_b", bundle_name="scenario_b")

    def lower_bounds(self):
        return [-np.inf] * self.num_constraints

    def upper_bounds(self):
        return [0.0] * self.num_constraints

    def constraints(self, model: BoundModel, params: ParameterRegistry, cfg, stage_idx: int):
        pos_x, pos_y = model.get("x"), model.get("y")
        zero = torch.zeros_like(pos_x)
        psi = model.get_or("psi", zero)
        slack = model.get_or("slack", zero) if self.use_slack else zero
        out = []
        for d in range(self.n_discs):
            offset = params.get(f"ego_disc_{d}_offset")
            px = pos_x + offset * torch.cos(psi)
            py = pos_y + offset * torch.sin(psi)
            for i in range(self.n_constraints):
                a1 = params.get(f"disc_{d}_scenario_constraint_{i}_a1")
                a2 = params.get(f"disc_{d}_scenario_constraint_{i}_a2")
                b = params.get(f"disc_{d}_scenario_constraint_{i}_b")
                out.append(a1 * px + a2 * py - (b + slack))
        return out

    # -- host half ---------------------------------------------------------
    def attach(self, planner) -> None:
        self._planner = planner

    def _scope(self, name: str):
        if self._planner is None:
            return contextlib.nullcontext()
        return self._planner.profiler.scope(name)

    def on_data_received(self, data, data_name: str) -> None:
        # A fresh draw when new obstacle data arrives (ref
        # scenario_constraints.cpp:114-129 draws per-solver samples)
        if data_name == "dynamic obstacles":
            self._sample_seed += 1

    def draw(self, B: int, M: int, n_stages: int, logprob=None):
        """This cycle's draws on the solver's device: noise [B, S, M, N-1, 2]
        standard normal and, for a mixture (`logprob` [M, K] log mode
        probabilities), mode_idx [B, S, M] (Gumbel-max, one categorical draw
        per sample and obstacle; else None). One generator seeded from the
        sample seed makes both, so solver b's draws are fixed by the seed and
        the shapes, and carried duals stay aligned per solver. The noise is
        generated stage-major and returned as a view in the reference's
        layout, the one the halfspaces read fastest."""
        dev = self._planner.solver.device
        S = self.n_samples
        gen = torch.Generator(device=dev).manual_seed(self._sample_seed)
        mode_idx = None
        if logprob is not None:
            u = torch.rand((B, S, M, logprob.shape[-1]), generator=gen, device=dev)
            gumbel = -torch.log(-torch.log(u.clamp_(min=1e-20)))
            mode_idx = torch.argmax(logprob + gumbel, dim=-1)
            del u, gumbel
        noise = torch.randn((B, n_stages, 2, S, M), generator=gen, device=dev)
        return noise.permute(0, 3, 4, 1, 2), mode_idx

    def optimize(self, state, data, module_data):
        """SH-MPC batched parallel optimize (ref scenario_constraints.cpp:
        58-107): per-solver draws -> tightest-halfspace selection -> parallel
        solves -> the best-cost feasible solver."""
        planner = self._planner
        blk = data.obstacle_block
        if planner is None or blk is None:
            return None

        cfg = self.cfg
        model = planner.model
        solver = planner.solver
        dev = solver.device
        N = cfg.N
        B = cfg.scenario_constraints.parallel_solvers
        M = blk.position.shape[0]
        Z_main = module_data.warmstart

        with self._scope("scenario_host_assemble"):
            Z0 = np.tile(np.asarray(Z_main, dtype=np.float32)[None], (B, 1, 1))
            span = float(cfg.scenario_constraints.warmstart_span)
            if span > 0.0 and B > 1:
                # Lateral warm-start fan over the solvers (ref :217-232): each
                # solver's trajectory offset sideways, tapering in over the
                # horizon; the solver nearest the middle keeps the warm start.
                offs = np.linspace(-span / 2.0, span / 2.0, B).astype(np.float32)
                offs[np.argmin(np.abs(offs))] = 0.0
                taper = np.clip(np.arange(N + 1) / max(N // 2, 1), 0.0, 1.0)
                xy = module_data.warmstart_xy
                d = np.diff(xy, axis=0, append=xy[-1:] + (xy[-1:] - xy[-2:-1]))
                nrm = np.linalg.norm(d, axis=1, keepdims=True)
                normal = np.stack([-d[:, 1], d[:, 0]], axis=1) / np.maximum(nrm, 1e-6)
                shift = offs[:, None, None] * (taper[:, None] * normal)[None]
                Z0[:, :, model.index("x")] += shift[..., 0]
                Z0[:, :, model.index("y")] += shift[..., 1]
            xinit = np.tile(module_data.xinit[None], (B, 1)).astype(np.float32)

            def on_dev(x):
                return torch.as_tensor(np.asarray(x, np.float32), device=dev)

            if blk.n_modes > 1:
                modes_angle = (blk.modes_angle if blk.modes_angle is not None
                               else np.zeros_like(blk.modes_major))
                obstacles = dict(
                    position=on_dev(blk.modes_position[:, :, : N - 1]),
                    angle=on_dev(modes_angle[:, :, : N - 1]),
                    major=on_dev(blk.modes_major[:, :, : N - 1]),
                    minor=on_dev(blk.modes_minor[:, :, : N - 1]))
                logprob = on_dev(np.log(np.maximum(blk.modes_prob, 1e-12)))
            else:
                obstacles = dict(position=on_dev(blk.pred_position[:, : N - 1]),
                                 angle=on_dev(blk.pred_angle[:, : N - 1]),
                                 major=on_dev(blk.pred_major[:, : N - 1]),
                                 minor=on_dev(blk.pred_minor[:, : N - 1]))
                logprob = None
            inputs = dict(base_P=on_dev(module_data.pblock.data), Z0=on_dev(Z0),
                          xinit=on_dev(xinit), radius=on_dev(blk.radius),
                          p_ws=on_dev(module_data.warmstart_xy[1:N]), **obstacles)

        # Cross-cycle dual warm start (HPIPM warm_start=2 across cycles):
        # scenario solver b keeps its draws' alignment between cycles.
        warm = self._prev_duals
        if warm is not None and warm[0].shape[0] != B:
            warm = None
        n_iter = int(module_data.num_iterations)
        reg = module_data.pblock.registry

        with self._scope("scenario_dispatch_solve_pull"):
            draws = self.draw(B, M, N - 1, logprob)
            packed_d, Zall, ll, lu = self._fused_step(reg, n_iter, warm, draws, **inputs)
            # THE one device -> host copy of the dispatch
            (Z_best, best, found, exit_codes, pobj, qp_mu,
             support, cert, cert_valid) = self._unpack(packed_d.cpu().numpy(), B)
        self._prev_duals = (ll, lu, torch.as_tensor(exit_codes == 1, device=dev))

        # In-cycle escalation of hard warm-dual failures and soft stalls
        # (feasible, mu above qp_mu_stall), on the same draws (ref :310-352).
        stalled_f = (exit_codes == 1) & (qp_mu > solver.qp_mu_stall)
        if solver.qp_retry_cold and ((exit_codes == -1) | stalled_f).any():
            # Cold cycles escalate every flagged solver; warm cycles only
            # those whose carried duals were applied.
            applied = np.ones(B, bool) if warm is None else warm[2].cpu().numpy()
            failed = (exit_codes == -1) & applied
            stalled = stalled_f & applied
            if (failed | stalled).any():
                with self._scope("scenario_escalation"):
                    packed_c, Zall_c, ll_c, lu_c = self._fused_step(
                        reg, n_iter, None, draws, escalated=True, **inputs)
                    (_, _, _, codes_cold, pobj_cold, _, support_cold, cert_cold,
                     valid_cold) = self._unpack(packed_c.cpu().numpy(), B)
                adopt = (failed & (codes_cold > exit_codes)) | (stalled & (codes_cold == 1))
                if adopt.any():
                    exit_codes = np.where(adopt, codes_cold, exit_codes)
                    pobj = np.where(adopt, pobj_cold, pobj)
                    support = np.where(adopt, support_cold, support)
                    cert = np.where(adopt, cert_cold, cert)
                    cert_valid = np.where(adopt, valid_cold, cert_valid)
                    mm = torch.as_tensor(adopt, device=dev)[:, None, None]
                    Zall = torch.where(mm, Zall_c, Zall)
                    self._prev_duals = (torch.where(mm, ll_c, ll), torch.where(mm, lu_c, lu),
                                        torch.as_tensor(exit_codes == 1, device=dev))
                    masked = np.where(exit_codes == 1, pobj, np.inf)
                    best = int(np.argmin(masked))
                    found = bool(np.isfinite(masked[best]))
                    Z_best = Zall[best].cpu().numpy()

        # The cycle's scenario-theory record (every solver): the largest
        # per-stage support, the certificate eps(s), whether pruning was exact
        self._last_support_all = support
        self._last_cert_all = cert
        self._last_cert_valid_all = np.asarray(cert_valid, bool)
        if not found:
            self._last_certificate = 1.0
            return {"Z": np.asarray(Z_main), "exit_code": -1, "pobj": float("inf")}
        self._last_selected = best
        self._last_n_feasible = int((exit_codes == 1).sum())
        self._last_certificate = float(cert[best])
        self._last_support_max = int(support[best])
        self._last_cert_valid = bool(cert_valid[best])
        return {"Z": Z_best, "exit_code": 1, "pobj": float(pobj[best]), "batch": True,
                "selected": best}

    def _unpack(self, packed: np.ndarray, B: int):
        """(Z of the winner, its index, found, exit codes, pobj, final mu,
        support, certificate, certificate valid) of one packed vector."""
        N, nvar = self.cfg.N, self._planner.model.nvar
        nz = (N + 1) * nvar
        field = [packed[nz + i * B:nz + (i + 1) * B] for i in range(6)]
        return (packed[:nz].reshape(N + 1, nvar), int(packed[-2]), bool(packed[-1] > 0.5),
                field[0].astype(np.int32), field[1].astype(float), field[2].astype(float),
                field[3].astype(float), field[4].astype(float), field[5] > 0.5)

    def _h_row_offset(self) -> int:
        """Row offset of this module's constraints within the stacked h rows
        (module order; the solver's rows are [u box | x box | h])."""
        off = 0
        for m in self._planner.modules:
            if m is self:
                return off
            off += m.nh
        raise RuntimeError("scenario module not found in planner modules")

    def _fused_step(self, reg, n_iter: int, warm, draws, *, base_P, Z0, xinit, radius, p_ws,
                    position, angle, major, minor, escalated: bool = False):
        """The device step of one SH-MPC cycle (the reference's one jitted
        program, mpc_planner_tpu/modules/scenario_constraints.py:390-541),
        on the solver's device, in this order:

        1. the halfspaces of this cycle's `draws` (noise, mode_idx);
        2. the tightest `n_constraints` per stage and solver;
        3. the per-solver parameter blocks (every disc gets the same rows;
           the terminal row copies stage N-1);
        4. the batched solve (`SQPSolver.batch_impl`, with the carried duals
           when `warm` is given);
        5. the best-cost feasible solver;
        6. per stage, the support count (distinct joint scenarios among the
           kept halfspaces whose dual is active on any disc), the pruning
           check (every discarded sample's halfspace holds at the solution,
           on every disc), and the certificate eps(max support) per solver
           (1 where pruning was not exact).

        Returns (packed, Z of every solver, lam_l, lam_u): `packed` is one
        f32 vector [Z of the winner, exit codes, pobj, qp_mu, support max,
        certificate, pruning exact, best, found]."""
        planner = self._planner
        model, ocp = planner.model, planner.ocp
        N, nC, D, S = self.cfg.N, self.n_constraints, self.n_discs, self.n_samples
        B = Z0.shape[0]
        noise, mode_idx = draws
        if self._bundle_idx is None or self._bundle_idx[0].device != base_P.device:
            self._bundle_idx = tuple(
                torch.as_tensor(reg.bundle_indices(f"scenario_{c}"), dtype=torch.long,
                                device=base_P.device) for c in ("a1", "a2", "b"))
        a1_idx, a2_idx, b_idx = self._bundle_idx
        robot_r = float(self.cfg.robot_radius)

        a1f, a2f, bf, margin = _halfspaces(
            *_scenario_samples(noise, mode_idx, position, angle, major, minor),
            radius, p_ws, robot_r)
        a1, a2, b, idx = _select_tightest(a1f, a2f, bf, margin, nC)  # [B, N-1, nC]
        del margin
        sample_idx = torch.div(idx, radius.shape[0], rounding_mode="floor")

        P = base_P[None].expand((B,) + tuple(base_P.shape)).clone()
        P[:, 1:N, a1_idx] = a1.repeat(1, 1, D)
        P[:, 1:N, a2_idx] = a2.repeat(1, 1, D)
        P[:, 1:N, b_idx] = b.repeat(1, 1, D)
        P[:, N] = P[:, N - 1]

        res = planner.solver.batch_impl(Z0, P, xinit, n_iter, warm0=warm, escalated=escalated)
        masked = torch.where(res.exit_code == 1, res.pobj, math.inf)
        best = torch.argmin(masked)
        found = torch.isfinite(masked[best])

        # -- scenario-theory accounting ------------------------------------
        row0 = ocp.nu + ocp.nx + self._h_row_offset()
        lam = res.lam_u[:, 1:N, row0:row0 + D * nC].reshape(B, N - 1, D, nC).amax(dim=2)
        active = (lam > self.ACTIVE_DUAL_TOL).to(torch.float32)
        support = torch.zeros((B, N - 1, S), dtype=torch.float32, device=P.device).scatter_reduce_(
            -1, sample_idx, active, "amax").sum(-1)  # [B, N-1]

        Zs = res.Z[:, 1:N]
        px, py = Zs[..., model.index("x")], Zs[..., model.index("y")]
        if "psi" in model.states:
            cpsi, spsi = torch.cos(Zs[..., model.index("psi")]), torch.sin(Zs[..., model.index("psi")])
        else:
            cpsi, spsi = torch.ones_like(px), torch.zeros_like(px)
        has_slack = "slack" in model.states or "slack" in model.inputs
        slack = Zs[..., model.index("slack")] if has_slack else torch.zeros_like(px)
        offsets = base_P[1, torch.as_tensor(reg.bundle_indices("ego_disc_offset"), dtype=torch.long,
                                            device=P.device)]  # [D], equal at every stage
        viol = None  # [B, N-1, S*M]: the worst disc, one disc at a time
        for d in range(D):
            pdx = (px + offsets[d] * cpsi)[..., None]
            pdy = (py + offsets[d] * spsi)[..., None]
            v = a1f * pdx + a2f * pdy - bf - slack[..., None]
            viol = v if viol is None else torch.maximum(viol, v)
            del v
        del a1f, a2f, bf
        kept = torch.zeros(viol.shape, dtype=torch.bool, device=P.device).scatter_(-1, idx, True)
        disc_viol = viol.masked_fill_(kept, -math.inf).amax(dim=-1)
        del viol, kept
        prune_ok = (disc_viol <= self.PRUNE_TOL).all(dim=-1)  # [B]

        eps_k = epsilon_posterior_torch(support, S, self._beta_stage)
        cert = torch.where(prune_ok, eps_k.amax(dim=-1), 1.0)
        packed = torch.cat([
            res.Z[best].reshape(-1),
            res.exit_code.to(torch.float32),
            res.pobj,
            res.qp_mu.to(torch.float32),
            support.amax(dim=-1),
            cert,
            prune_ok.to(torch.float32),
            torch.stack([best.to(torch.float32), found.to(torch.float32)]),
        ])
        return packed, res.Z, res.lam_l, res.lam_u

    def set_parameters(self, data, module_data, pblock: ParameterBlock) -> None:
        n_stages = pblock.n_stages
        nC = self.num_constraints
        if data.robot_area:
            pblock.set_bundle_all_stages(
                "ego_disc_offset", np.array([o for o, _ in data.robot_area]))
        pblock.set_bundle_all_stages("scenario_a1", np.ones((n_stages, nC)))
        pblock.set_bundle_all_stages("scenario_a2", np.zeros((n_stages, nC)))
        pblock.set_bundle_all_stages("scenario_b", np.full((n_stages, nC), 1e6))

    def save_data(self, record: dict) -> None:
        """Per-cycle scenario solver metrics (ref scenario_constraints.cpp
        saveData), with the cycle's risk certificate: the a-posteriori bound
        eps(s) of the selected solver at confidence 1 - confidence (1.0: no
        guarantee this cycle, infeasible or pruning inexact)."""
        sc = self.cfg.scenario_constraints
        record["scenario_selected_solver"] = getattr(self, "_last_selected", -1)
        record["scenario_n_solvers"] = sc.parallel_solvers
        record["scenario_n_feasible"] = getattr(self, "_last_n_feasible", 0)
        record["scenario_n_samples"] = self.n_samples
        record["scenario_risk_certificate"] = getattr(self, "_last_certificate", 1.0)
        record["scenario_support_max"] = getattr(self, "_last_support_max", -1)
        record["scenario_cert_valid"] = getattr(self, "_last_cert_valid", False)
        record["scenario_support_bound_exceeded"] = (
            getattr(self, "_last_support_max", -1) > sc.support_bound)

    def reset(self) -> None:
        self._prev_duals = None
        self._sample_seed = 0

    def is_data_ready(self, data):
        if getattr(data, "obstacle_block", None) is None:
            return False, "Obstacles"
        return True, ""
