"""Shared builders for the tests that hold the PyTorch port
(mpc_planner_tpu_torch) against the JAX package (mpc_planner_tpu).

Each builder makes the same inputs for both packages from a seed with
numpy; the tests hand them over as numpy arrays (or through
mpc_planner_tpu_torch.interop). Small sizes: N=10, B=4, 4 RTI iterations,
like tests/conftest.py's `cfg`. torch runs on one thread because the
tier-1 run has several xdist workers.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

import mpc_planner_tpu.presets as jax_presets
import mpc_planner_tpu_torch.presets as torch_presets
from mpc_planner_tpu.parameters import ParameterBlock as JaxParameterBlock
from mpc_planner_tpu.planner import Planner as JaxPlanner
from mpc_planner_tpu.solver.ocp import OCP as JaxOCP
from mpc_planner_tpu.solver.warmstart import initialize_with_state as jax_initialize_with_state
from mpc_planner_tpu.utils.config import default_config as jax_default_config
from mpc_planner_tpu.types import ModuleData as JaxModuleData
from mpc_planner_tpu_torch.parameters import ParameterBlock as TorchParameterBlock
from mpc_planner_tpu_torch.planner import Planner as TorchPlanner
from mpc_planner_tpu_torch.solver.ocp import OCP as TorchOCP
from mpc_planner_tpu_torch.solver.warmstart import initialize_with_state as torch_initialize_with_state
from mpc_planner_tpu_torch.types import ModuleData as TorchModuleData
from mpc_planner_tpu_torch.utils.config import default_config as torch_default_config

torch.set_num_threads(1)

N_SMALL = 10
SOLVER_SMALL = dict(iterations=4, qp_iterations=10)


@dataclasses.dataclass
class Side:
    """One package's build of a configuration."""

    cfg: object
    model: object
    modules: object
    state: object = None
    data: object = None


def jackal_goal_pair(N: int = N_SMALL, n_pedestrians: int = 6, seed: int = 0, **solver):
    """system_jackal("goal") built by both packages, with the same
    corridor scene (same seed). `solver` overrides SolverConfig fields."""
    sides = []
    for presets in (jax_presets, torch_presets):
        cfg, model, modules = presets.system_jackal("goal", N=N)
        if solver:
            cfg, model, modules = presets.system_jackal(
                "goal", N=N, solver=dataclasses.replace(cfg.solver, **solver))
        state, data = presets.corridor_scene(cfg, n_pedestrians=n_pedestrians, seed=seed)
        sides.append(Side(cfg, model, modules, state, data))
    return sides[0], sides[1]


def parameter_blocks(jax_side: Side, torch_side: Side, jax_params, torch_params):
    """Each package's own host half fills its [N+1, npar] block for the
    same scene; returns (jax_block, torch_block) as numpy arrays."""
    N = jax_side.cfg.N
    out = []
    for side, params, PB, MD in ((jax_side, jax_params, JaxParameterBlock, JaxModuleData),
                                 (torch_side, torch_params, TorchParameterBlock, TorchModuleData)):
        pb = PB(params, N + 1)
        side.modules.set_parameters_all(side.data, MD(), pb)
        pb.data[N] = pb.data[N - 1]
        out.append(pb.data)
    return out


def place_near_pedestrian(state, data, gap: float, speed: float):
    """Put the robot `gap` m behind the first real pedestrian, heading at
    it, so the obstacle rows of the QP are active within a short horizon."""
    obs = data.obstacle_block
    i = int(np.argmax(obs.index >= 0))
    state.set("x", obs.position[i, 0] - gap)
    state.set("y", obs.position[i, 1])
    state.set("v", speed)
    data.ego_position = state.get_position()


def jax_qp_case(name: str, B: int = 4, iterations: int = 8):
    """QPs built by the JAX solver for the QP tests of both the plain
    version and the kernel body: `name` "goal" (goal tracking on the 4-state
    unicycle, nh=0) or "jackal" (system_jackal("goal") with the robot 2 m
    behind a pedestrian at 1 m/s, nh=12: obstacle rows active and the duals
    unique; some placements make an obstacle row and a box row active
    together, where no two solvers agree on the duals). B perturbed warm
    starts; the SQP loop's next QPs (relinearized at Z + dz) with the first
    QPs' duals, element 2's rejected (ok=False: it starts cold)."""
    import jax
    import jax.numpy as jnp

    from mpc_planner_tpu.models import SecondOrderUnicycleModel
    from mpc_planner_tpu.modules import GoalModule, ModuleManager, MPCBaseModule
    from mpc_planner_tpu.solver.qp import solve_qp as jax_solve_qp
    from mpc_planner_tpu.solver.sqp import SQPSolver
    from mpc_planner_tpu.types import RealTimeData, State

    if name == "goal":
        cfg = jax_default_config(N=N_SMALL)
        cfg = cfg.replace(solver=cfg.solver.__class__(**SOLVER_SMALL))
        model = SecondOrderUnicycleModel()
        mgr = ModuleManager()
        base = mgr.add_module(MPCBaseModule(cfg))
        base.weigh_variable("a", "acceleration")
        base.weigh_variable("w", "angular_velocity")
        mgr.add_module(GoalModule(cfg))
        data = RealTimeData()
        data.goal = np.array([4.0, 1.0])
        data.goal_received = True
        state = State(model)
    else:
        js, _ = jackal_goal_pair(n_pedestrians=6, seed=3)
        place_near_pedestrian(js.state, js.data, gap=2.0, speed=1.0)
        model, cfg, mgr, data, state = js.model, js.cfg, js.modules, js.data, js.state
    ocp = JaxOCP(model, mgr, cfg)
    solver = SQPSolver(ocp)
    pblock = JaxParameterBlock(ocp.params, cfg.N + 1)
    mgr.set_parameters_all(data, JaxModuleData(), pblock)
    pblock.data[cfg.N] = pblock.data[cfg.N - 1]
    Zb = perturbed_warmstarts(jax_initialize_with_state(model, cfg.N, state), model.nu, B)
    Pb = np.tile(pblock.data[None], (B, 1, 1)).astype(np.float32)
    linearize = jax.vmap(solver._linearize)
    qp = linearize(jnp.asarray(Zb), jnp.asarray(Pb))
    with jax.default_matmul_precision("highest"):
        first = jax.vmap(lambda d: jax_solve_qp(d, model.nu, model.nx, iterations=iterations))(qp)
    qp_next = linearize(jnp.asarray(Zb) + first.dz, jnp.asarray(Pb))
    ok = np.array([True, True, False, True])
    return dict(name=name, model=model, nh=ocp.nh, qp=qp, qp_next=qp_next,
                warm=(np.asarray(first.lam_l), np.asarray(first.lam_u), ok))


def jax_qp_reference(case, warm: bool, mehrotra: bool, iterations: int):
    """The JAX package's solve_qp (vmapped, full-precision matmuls) on a
    jax_qp_case: the first QPs cold, or the next QPs with the warm duals."""
    import jax
    import jax.numpy as jnp

    from mpc_planner_tpu.solver.qp import solve_qp as jax_solve_qp

    nu, nx = case["model"].nu, case["model"].nx
    with jax.default_matmul_precision("highest"):
        if not warm:
            return jax.vmap(lambda d: jax_solve_qp(d, nu, nx, iterations=iterations,
                                                   mehrotra=mehrotra))(case["qp"])
        return jax.vmap(lambda d, wl, wu, ok: jax_solve_qp(
            d, nu, nx, iterations=iterations, warm_duals=(wl, wu, ok), mehrotra=mehrotra))(
            case["qp_next"], *(jnp.asarray(w) for w in case["warm"]))


def perturbed_warmstarts(Z0: np.ndarray, nu: int, B: int, seed: int = 0, scale: float = 0.05):
    """[B, N+1, nvar] copies of Z0 with seeded noise on the states of
    stages 1..N (the bench.py recipe)."""
    rng = np.random.default_rng(seed)
    Zb = np.tile(Z0[None], (B, 1, 1)).astype(np.float32)
    Zb[:, 1:, nu:] += rng.normal(0, scale, Zb[:, 1:, nu:].shape).astype(np.float32)
    return Zb


def host_pass(pkg: str, cfg, configuration: str = "configuration_tmpc", n_pedestrians: int = 6,
              seed: int = 7, speed: float = 1.2, scene=None):
    """One host pass of a preset configuration in package `pkg` ("jax" or
    "torch") on corridor_scene: `scene(state, data)` may edit the scene
    first; then update_all around the state-held warm start and the
    parameter fill. Returns the pieces as a dict (P: the block)."""
    if pkg == "jax":
        P, Block, MD, init, OCP = (jax_presets, JaxParameterBlock, JaxModuleData,
                                   jax_initialize_with_state, JaxOCP)
    else:
        P, Block, MD, init, OCP = (torch_presets, TorchParameterBlock, TorchModuleData,
                                   torch_initialize_with_state, TorchOCP)
    model, modules = getattr(P, configuration)(cfg)
    ocp = OCP(model, modules, cfg)
    state, data = P.corridor_scene(cfg, n_pedestrians=n_pedestrians, seed=seed)
    state.set("v", speed)
    if scene is not None:
        scene(state, data)
    modules.on_data_received(data, "reference_path")
    Z0 = init(model, cfg.N, state)
    md = MD()
    md.warmstart = Z0
    md.warmstart_xy = Z0[:, [model.index("x"), model.index("y")]]
    md.warmstart_psi = Z0[:, model.index("psi")]
    md.warmstart_spline = Z0[:, model.index("spline")]
    modules.update_all(state, data, md)
    pblock = Block(ocp.params, cfg.N + 1)
    modules.set_parameters_all(data, md, pblock)
    return dict(model=model, modules=modules, ocp=ocp, state=state, data=data, md=md,
                P=pblock.data, Z0=Z0)


def tmpc_planner_pair(N: int = N_SMALL, solver=None):
    """configuration_tmpc planners of both packages on corridor_scene(6
    pedestrians, seed 7), each recording its device steps in `steps`."""
    solver = SOLVER_SMALL if solver is None else solver
    jc, tc = jax_default_config(N=N), torch_default_config(N=N)
    jc = jc.replace(solver=jc.solver.__class__(**solver))
    tc = tc.replace(solver=tc.solver.__class__(**solver))
    out = []
    for P, make, cfg in ((jax_presets, JaxPlanner, jc), (torch_presets, TorchPlanner, tc)):
        model, modules = P.configuration_tmpc(cfg)
        planner = make(model, modules, cfg)
        state, data = P.corridor_scene(cfg, n_pedestrians=6, seed=7)
        planner.on_data_received(data, "reference_path")
        out.append(dict(planner=planner, module=modules.get("GuidanceConstraints"), state=state,
                        data=data, steps=[]))
    jax_side, torch_side = out
    _record_jax(jax_side)
    _record_torch(torch_side)
    return jax_side, torch_side


def _record_jax(side):
    """Keep (packed, Z of every planner, escalated) of every device step."""
    module = side["module"]
    build = module._get_fused_step

    def get_step(*args, escalated=False, **kw):
        step = build(*args, escalated=escalated, **kw)

        def run(*inputs):
            out = step(*inputs)
            side["steps"].append((np.asarray(out[0]), np.asarray(out[1]), escalated))
            return out
        return run

    module._get_fused_step = get_step


def _record_torch(side):
    module = side["module"]
    step = module._fused_step

    def run(*args, escalated=False, **kw):
        out = step(*args, escalated=escalated, **kw)
        side["steps"].append((out[0].numpy(), out[1].numpy(), escalated))
        return out

    module._fused_step = run


def compare_tmpc_steps(jax_side, torch_side, atol: float = 5e-3):
    """Every recorded device step: exit codes, winner, Z of every planner
    and pobj of the feasible ones."""
    assert len(torch_side["steps"]) == len(jax_side["steps"]) > 0
    module = torch_side["module"]
    B = module.n_planners
    for (pj, Zj, ej), (pt, Zt, et) in zip(jax_side["steps"], torch_side["steps"]):
        assert et == ej
        Zb_j, best_j, found_j, codes_j, pobj_j, _ = module._unpack(pj, B)
        Zb_t, best_t, found_t, codes_t, pobj_t, _ = module._unpack(pt, B)
        np.testing.assert_array_equal(codes_t, codes_j)
        assert (best_t, found_t) == (best_j, found_j)
        np.testing.assert_allclose(Zt, Zj, atol=atol, rtol=0)
        np.testing.assert_allclose(Zb_t, Zb_j, atol=atol, rtol=0)
        ok = codes_j == 1
        np.testing.assert_allclose(pobj_t[ok], pobj_j[ok], rtol=atol)


def tmpc_cycle(jax_side, torch_side, atol: float = 5e-3):
    """One solve_mpc in both packages; the outcome, the selection record
    (save_data) and the batch Z agree. Returns the port's output."""
    outs = [s["planner"].solve_mpc(s["state"], s["data"]) for s in (jax_side, torch_side)]
    assert outs[1].success == outs[0].success
    rec_j, rec_t = (s["planner"].modules.save_data_all() for s in (jax_side, torch_side))
    assert rec_t["guidance_selected_planner"] == rec_j["guidance_selected_planner"]
    assert rec_t["guidance_n_feasible"] == rec_j["guidance_n_feasible"]
    np.testing.assert_allclose(rec_t["guidance_best_objective"], rec_j["guidance_best_objective"],
                               rtol=atol)
    np.testing.assert_allclose(torch_side["planner"]._Z, jax_side["planner"]._Z, atol=atol, rtol=0)
    np.testing.assert_allclose(torch_side["module"]._last_batch_Z.numpy(),
                               np.asarray(jax_side["module"]._last_batch_Z), atol=atol, rtol=0)
    return outs[1]
