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

import mpc_planner_tpu.models as jax_models
import mpc_planner_tpu.modules as jax_modules
import mpc_planner_tpu.presets as jax_presets
import mpc_planner_tpu_torch.models as torch_models
import mpc_planner_tpu_torch.modules as torch_modules
import mpc_planner_tpu_torch.presets as torch_presets
from mpc_planner_tpu.parameters import ParameterBlock as JaxParameterBlock
from mpc_planner_tpu.planner import Planner as JaxPlanner
from mpc_planner_tpu.solver.ocp import OCP as JaxOCP
from mpc_planner_tpu.solver.warmstart import initialize_with_state as jax_initialize_with_state
from mpc_planner_tpu.utils.config import default_config as jax_default_config
from mpc_planner_tpu.types import ModuleData as JaxModuleData
from mpc_planner_tpu_torch.parameters import ParameterBlock as TorchParameterBlock
from mpc_planner_tpu_torch.planner import Planner as TorchPlanner
from mpc_planner_tpu_torch.presets import two_wall_costmap
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


def jax_qp_case(name: str, B: int = 4, iterations: int = 8, raw_only: bool = False):
    """QPs built by the JAX solver for the QP tests of both the plain
    version and the kernel body: `name` "goal" (goal tracking on the 4-state
    unicycle, nh=0) or "jackal" (system_jackal("goal") with the robot 2 m
    behind a pedestrian at 1 m/s, nh=12: obstacle rows active and the duals
    unique; some placements make an obstacle row and a box row active
    together, where no two solvers agree on the duals). B perturbed warm
    starts; the SQP loop's next QPs (relinearized at Z + dz) with the first
    QPs' duals, element 2's rejected (ok=False: it starts cold). `qp_raw`
    and `qp_next_raw` are the same QPs before the MIRROR. Any other `name` is
    a key of FAMILIES (N=8, 3 pedestrians, after one host pass): the
    (nu, nx) the bicycle, the point mass and the slack model bring.
    `raw_only`: only `qp_raw` (one traced linearization instead of four)."""
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
    elif name == "jackal":
        js, _ = jackal_goal_pair(n_pedestrians=6, seed=3)
        place_near_pedestrian(js.state, js.data, gap=2.0, speed=1.0)
        model, cfg, mgr, data, state = js.model, js.cfg, js.modules, js.data, js.state
    if name in ("goal", "jackal"):
        ocp = JaxOCP(model, mgr, cfg)
        pblock = JaxParameterBlock(ocp.params, cfg.N + 1)
        mgr.set_parameters_all(data, JaxModuleData(), pblock)
        pblock.data[cfg.N] = pblock.data[cfg.N - 1]
        Z0, P0 = jax_initialize_with_state(model, cfg.N, state), pblock.data
    else:
        kwargs, edit = FAMILIES[name]
        js, _ = system_pair(N=8, n_pedestrians=3, seed=3, **kwargs)
        if edit is not None:
            edit(js)
        hp = side_host_pass("jax", js, speed=1.0)
        model, ocp, Z0, P0 = js.model, hp["ocp"], hp["Z0"], hp["P"]
    solver = SQPSolver(ocp)
    Zb = perturbed_warmstarts(Z0, model.nu, B)
    Pb = np.tile(P0[None], (B, 1, 1)).astype(np.float32)
    raw = jax.vmap(lambda Z, P: solver._linearize(Z, P, mirror=False))
    if raw_only:
        return dict(name=name, model=model, nh=ocp.nh, qp_raw=raw(jnp.asarray(Zb), jnp.asarray(Pb)),
                    lm=float(solver.lm), x_only=bool(solver._mirror_x_only))
    linearize = jax.vmap(solver._linearize)
    qp = linearize(jnp.asarray(Zb), jnp.asarray(Pb))
    with jax.default_matmul_precision("highest"):
        first = jax.vmap(lambda d: jax_solve_qp(d, model.nu, model.nx, iterations=iterations))(qp)
    qp_next = linearize(jnp.asarray(Zb) + first.dz, jnp.asarray(Pb))
    ok = np.array([True, True, False, True])
    # `raw`: the same QPs with their RAW Hessians, for a QP kernel that runs the
    # MIRROR itself; lm and whether only the x-block is eigendecomposed
    return dict(name=name, model=model, nh=ocp.nh, qp=qp, qp_next=qp_next,
                warm=(np.asarray(first.lam_l), np.asarray(first.lam_u), ok),
                qp_raw=raw(jnp.asarray(Zb), jnp.asarray(Pb)),
                qp_next_raw=raw(jnp.asarray(Zb) + first.dz, jnp.asarray(Pb)),
                lm=float(solver.lm), x_only=bool(solver._mirror_x_only))


def qp_solutions_agree(out, ref, tol, dz_scale=0.0):
    """dz, the duals and mu of two QP solutions within `tol` of max |ref|.
    `dz_scale`: the size dz is measured against where the step itself is ~0
    (a QP relinearized at the solution of a linear-quadratic OCP)."""
    for f in ("dz", "lam_l", "lam_u", "mu"):
        o, r = np.asarray(getattr(out, f)), np.asarray(getattr(ref, f))
        assert o.shape == r.shape, f
        scale = max(np.abs(r).max(), dz_scale if f == "dz" else 0.0) + 1e-9
        assert np.abs(o - r).max() / scale < tol, f


def host_build_dir(tmp_path_factory, name: str) -> str:
    """A directory for a host build of a kernel's body; skips the test
    without a C++ compiler and ninja."""
    import os
    import shutil

    import pytest

    cxx = os.environ.get("CXX", "c++")
    if shutil.which(cxx) is None or shutil.which("ninja") is None:
        pytest.skip(f"needs a C++ compiler ({cxx}) and ninja")
    return str(tmp_path_factory.mktemp(name))


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


def system_pair(name: str = None, variant: str = None, N: int = N_SMALL, n_pedestrians: int = 3,
                seed: int = 3, solver=None, costmap: bool = False, build=None, scenario=None,
                **cfg_overrides):
    """A system preset (`select_system(name, variant)`) or a configuration
    (`build(presets, cfg) -> (model, modules)`) built by both packages with
    the small solver settings (and `scenario` overrides of the SH-MPC
    section), each with the same corridor scene (and the same synthetic
    costmap)."""
    solver = SOLVER_SMALL if solver is None else solver
    sides = []
    for presets, default in ((jax_presets, jax_default_config), (torch_presets, torch_default_config)):
        if build is None:
            cfg, _, _ = presets.select_system(name, variant, N=N, **cfg_overrides)
            if scenario:
                cfg_overrides = dict(cfg_overrides, scenario_constraints=dataclasses.replace(
                    cfg.scenario_constraints, **scenario))
            cfg, model, modules = presets.select_system(
                name, variant, N=N, solver=dataclasses.replace(cfg.solver, **solver), **cfg_overrides)
            cfg_overrides.pop("scenario_constraints", None)
        else:
            cfg = default(N=N, **cfg_overrides)
            cfg = cfg.replace(solver=dataclasses.replace(cfg.solver, **solver))
            model, modules = build(presets, cfg)
        state, data = presets.corridor_scene(cfg, n_pedestrians=n_pedestrians, seed=seed)
        if costmap:
            data.costmap, data.costmap_meta = two_wall_costmap(seed)
        sides.append(Side(cfg, model, modules, state, data))
    return sides[0], sides[1]


def side_host_pass(pkg: str, side: Side, speed: float = 1.2):
    """One host pass of a built Side in package `pkg` ("jax" or "torch"):
    on_data_received, update_all around the state-held warm start, and the
    parameter fill with its terminal row. Returns a dict (P: the block)."""
    Block, MD, init, OCP = ((JaxParameterBlock, JaxModuleData, jax_initialize_with_state, JaxOCP)
                            if pkg == "jax" else
                            (TorchParameterBlock, TorchModuleData, torch_initialize_with_state,
                             TorchOCP))
    model, modules, cfg = side.model, side.modules, side.cfg
    ocp = OCP(model, modules, cfg)
    side.state.set("v", speed)
    modules.on_data_received(side.data, "reference_path")
    Z0 = init(model, cfg.N, side.state)
    md = MD()
    md.warmstart = Z0
    md.warmstart_xy = Z0[:, [model.index("x"), model.index("y")]]
    for attr, name in (("warmstart_psi", "psi"), ("warmstart_spline", "spline")):
        setattr(md, attr, Z0[:, model.index(name)] if name in model.states else np.zeros(cfg.N + 1))
    modules.update_all(side.state, side.data, md)
    pblock = Block(ocp.params, cfg.N + 1)
    modules.set_parameters_all(side.data, md, pblock)
    pblock.data[cfg.N] = pblock.data[cfg.N - 1]
    xinit = np.array([side.state.get(n) for n in model.states])
    return dict(ocp=ocp, md=md, P=pblock.data, Z0=Z0, xinit=xinit)


def planner_pair(jax_side: Side, torch_side: Side):
    """(JAX planner, port planner on the CPU) of two built Sides, the
    reference path received; as dicts like tmpc_planner_pair's."""
    out = []
    for make, side, kw in ((JaxPlanner, jax_side, {}), (TorchPlanner, torch_side, {"device": "cpu"})):
        planner = make(side.model, side.modules, side.cfg, **kw)
        planner.on_data_received(side.data, "reference_path")
        module = side.modules.get("GuidanceConstraints") if any(
            m.module_name == "GuidanceConstraints" for m in side.modules) else None
        out.append(dict(planner=planner, module=module, state=side.state, data=side.data, steps=[]))
    if any(m.module_name == "ScenarioConstraints" for m in torch_side.modules):
        inject_jax_draws(torch_side.modules.get("ScenarioConstraints"))
    return out[0], out[1]


# -- SH-MPC: the JAX package's draws in the port ------------------------------------
def jax_scenario_draws(seed: int, B: int, S: int, M: int, n_stages: int, logprob=None):
    """The draws of the JAX package's SH-MPC step for sample seed `seed`
    (mpc_planner_tpu/modules/scenario_constraints.py:281-282, :40, :74-82):
    noise [B, S, M, n_stages, 2] and, for a mixture (`logprob` [M, K]), the
    mode per sample [B, S, M], as numpy arrays."""
    import jax
    import jax.numpy as jnp

    keys = jax.random.split(jax.random.PRNGKey(seed), B)
    if logprob is None:
        return np.asarray(jax.vmap(lambda k: jax.random.normal(k, (S, M, n_stages, 2)))(keys)), None

    def one(key):
        k_mode, k_noise = jax.random.split(key)
        mode = jax.random.categorical(k_mode, jnp.asarray(logprob, jnp.float32), axis=-1,
                                      shape=(S, M))
        return jax.random.normal(k_noise, (S, M, n_stages, 2)), mode

    noise, mode = jax.vmap(one)(keys)
    return np.asarray(noise), np.asarray(mode)


def inject_jax_draws(module):
    """Make the port's scenario module draw what the JAX package draws for
    the module's current sample seed (through interop)."""
    from mpc_planner_tpu_torch import interop

    def draw(B, M, n_stages, logprob=None):
        lp = None if logprob is None else logprob.cpu().numpy()
        noise, mode = jax_scenario_draws(module._sample_seed, B, module.n_samples, M, n_stages, lp)
        return interop.scenario_draws_to_torch(noise, mode, device=module._planner.solver.device)

    module.draw = draw


def shmpc_planner_pair(name: str, gap: float = 2.0, **kw):
    """family_planner_pair of an SH-MPC family (the robot `gap` m behind a
    pedestrian, so that scenario rows are active), each side recording its
    device steps (`steps`) and the parameter blocks its solver received
    (`P`); the port draws the JAX draws."""
    js, ts = family_planner_pair(name, gap=gap, **kw)
    for side, pkg in ((js, "jax"), (ts, "torch")):
        side["module"] = side["planner"].modules.get("ScenarioConstraints")
        side["P"] = []
        solver = side["planner"].solver
        solve = solver.batch_impl
        if pkg == "jax":
            import jax

            def recorded(Z0, P, *a, _solve=solve, _side=side, **k):
                jax.debug.callback(lambda p: _side["P"].append(np.asarray(p)), P)
                return _solve(Z0, P, *a, **k)
            _record_jax(side)
        else:
            def recorded(Z0, P, *a, _solve=solve, _side=side, **k):
                _side["P"].append(P.numpy().copy())
                return _solve(Z0, P, *a, **k)
            _record_torch(side)
        solver.batch_impl = recorded
    return js, ts


def shmpc_cycle(jax_side, torch_side, atol: float = 5e-3, p_rtol: float = 1e-6):
    """One solve_mpc in both packages, compared step by step: parameter
    blocks within `p_rtol` (a first cycle: the same inputs; a later one
    starts from warm starts that agree within `atol`, pass p_rtol=None to
    hold its blocks to `atol`), Z of every solver and of the winner within
    `atol`, exit codes, support counts and pruning flags equal, the
    certificates within 1e-5, the winner equal (or, where the reference's
    feasible costs tie within 1e-5, one of the tied solvers: the argmin of
    equal costs is decided by rounding), and the save_data record. Returns
    the port's output."""
    n_steps = len(torch_side["steps"])
    outs = [s["planner"].solve_mpc(s["state"], s["data"]) for s in (jax_side, torch_side)]
    assert outs[1].success == outs[0].success
    module = torch_side["module"]
    B = module.cfg.scenario_constraints.parallel_solvers
    assert len(torch_side["steps"]) == len(jax_side["steps"]) > n_steps
    assert len(torch_side["P"]) == len(jax_side["P"]) == len(torch_side["steps"])
    for Pt, Pj in zip(torch_side["P"][n_steps:], jax_side["P"][n_steps:]):
        if p_rtol is None:
            np.testing.assert_allclose(Pt, Pj, rtol=0, atol=atol)
        else:
            np.testing.assert_allclose(Pt, Pj, rtol=p_rtol, atol=p_rtol)
    tied = np.zeros(B, bool)
    for (pj, Zj, ej), (pt, Zt, et) in zip(jax_side["steps"][n_steps:], torch_side["steps"][n_steps:]):
        assert et == ej
        uj, ut = module._unpack(pj, B), module._unpack(pt, B)
        np.testing.assert_array_equal(ut[3], uj[3])  # exit codes
        assert ut[2] == uj[2]  # found
        cost = np.where(uj[3] == 1, uj[4], np.inf)
        tied = cost <= cost[uj[1]] + 1e-5 * abs(cost[uj[1]])
        assert ut[1] == uj[1] or tied[ut[1]], (ut[1], uj[1], uj[4])  # the winner
        np.testing.assert_allclose(Zt, Zj, atol=atol, rtol=0)
        np.testing.assert_allclose(ut[0], uj[0], atol=atol, rtol=0)
        np.testing.assert_array_equal(ut[6], uj[6])  # support counts
        np.testing.assert_allclose(ut[7], uj[7], rtol=0, atol=1e-5)  # certificates
        np.testing.assert_array_equal(ut[8], uj[8])  # pruning exact
    rec_j, rec_t = (s["planner"].modules.save_data_all() for s in (jax_side, torch_side))
    assert sorted(rec_t) == sorted(rec_j)
    for key in rec_j:
        if key == "scenario_risk_certificate":
            np.testing.assert_allclose(rec_t[key], rec_j[key], rtol=0, atol=1e-5)
        elif key != "scenario_selected_solver" or not tied[rec_t[key]]:
            assert rec_t[key] == rec_j[key], key
    np.testing.assert_allclose(torch_side["planner"]._Z, jax_side["planner"]._Z, atol=atol, rtol=0)
    return outs[1]


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
        planner = make(model, modules, cfg, **({"device": "cpu"} if make is TorchPlanner else {}))
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


# -- the OCP families of the remaining modules and models -----------------------
def _with(module_of):
    """A `build` for system_pair: configuration_no_obstacles plus the
    constraint modules `module_of(modules package, cfg)` returns."""
    def build(presets, cfg):
        model, modules = presets.configuration_no_obstacles(cfg)
        for m in module_of(jax_modules if presets is jax_presets else torch_modules, cfg):
            modules.add_module(m)
        return model, modules
    return build


def _road_bounds(side: Side):
    xs = np.asarray(side.data.reference_path["x"], float)
    side.data.left_bound = np.stack([xs, 2.0 + 0.3 * np.sin(xs / 4.0)], axis=-1)
    side.data.right_bound = np.stack([xs, -2.5 + 0.2 * np.cos(xs / 5.0)], axis=-1)


def _curved_path(side: Side):
    xs = np.asarray(side.data.reference_path["x"], float)
    side.data.reference_path = {"x": xs, "y": 0.8 * np.sin(xs / 5.0)}


SHMPC_SMALL = dict(n_samples=32, parallel_solvers=4)

# name -> (system_pair arguments, an edit of each side's scene or None)
FAMILIES = {
    "cc": (dict(build=_with(lambda M, cfg: [M.GaussianConstraintModule(cfg)])), None),
    "linearized": (dict(build=_with(lambda M, cfg: [M.LinearizedConstraintModule(cfg)])), None),
    "linearized_topology": (dict(build=_with(
        lambda M, cfg: [M.LinearizedConstraintModule(cfg, use_guidance=True)])), None),
    "road": (dict(build=_with(lambda M, cfg: [M.ContouringConstraintModule(cfg)])), _road_bounds),
    "rosnavigation_lmpcc": (dict(name="rosnavigation", variant="lmpcc", costmap=True), None),
    "ellipsoid": (dict(name="jackalsimulator", variant="basic"), None),
    "jackal_tmpc": (dict(name="jackal", variant="tmpc"), None),
    "curvature_aware": (dict(name="jackalsimulator", variant="curvature_aware"), None),
    "bicycle": (dict(build=lambda presets, cfg: presets.configuration_bicycle(cfg)), None),
    "bicycle_ca": (dict(build=lambda presets, cfg: presets.configuration_bicycle(cfg, True)),
                   _curved_path),
    "dingo_lmpcc": (dict(name="dingo", variant="lmpcc"), None),
    "rosnavigation_tmpc": (dict(name="rosnavigation", variant="tmpc", costmap=True), None),
    # the rest of the presets and the KKT ladder's rungs (slow-marked tests)
    "tmpc_ca": (dict(name="jackalsimulator", variant="tmpc_ca"), None),
    "jackal_ca": (dict(name="jackal", variant="ca"), None),
    "dingo_tmpc": (dict(name="dingo", variant="tmpc"), None),
    "jackalsimulator_lmpcc": (dict(name="jackalsimulator", variant="lmpcc"), None),
    "jackal_lmpcc": (dict(name="jackal", variant="lmpcc"), None),
    "no_obstacles": (dict(name="jackalsimulator", variant="no_obstacles"), None),
    "tmpc": (dict(name="jackalsimulator", variant="tmpc"), None),
    "cc_static": (dict(build=_with(lambda M, cfg: [M.GaussianConstraintModule(cfg),
                                                    M.LinearizedConstraintModule(cfg)])), None),
    # SH-MPC at a small draw (the planner pairs inject the JAX draws into the
    # port: inject_jax_draws)
    "shmpc": (dict(name="jackalsimulator", variant="safe_horizon", scenario=SHMPC_SMALL), None),
    "shmpc_hard": (dict(name="jackalsimulator", variant="safe_horizon_hard",
                        scenario=SHMPC_SMALL), None),
    "rosnavigation_shmpc": (dict(name="rosnavigation", variant="safe_horizon", costmap=True,
                                 scenario=SHMPC_SMALL), None),
}


def family_case(name: str, N: int = 8, n_points: int = 8):
    """Both packages' build of family `name`, one host pass each on the
    same scene, and seeded (z, p) points: z normal with the spline state on
    the path and two standing robots; p = stage rows of the port's block
    with small noise (risks, chi and radii stay positive)."""
    kwargs, edit = FAMILIES[name]
    js, ts = system_pair(N=N, n_pedestrians=3, seed=3, **kwargs)
    for side in (js, ts):
        if edit is not None:
            edit(side)
        place_near_pedestrian(side.state, side.data, gap=2.0, speed=1.0)
    jp, tp = side_host_pass("jax", js, speed=1.0), side_host_pass("torch", ts, speed=1.0)
    rng = np.random.default_rng(0)
    model, ocp = ts.model, tp["ocp"]
    z = rng.normal(0.0, 1.0, (n_points, ocp.nvar))
    if "spline" in model.states:
        z[:, model.index("spline")] = rng.uniform(0.0, 10.0, n_points)
    if "v" in model.states:
        z[:2, model.index("v")] = 0.0
    if "delta" in model.states:
        z[:, model.index("delta")] *= 0.3  # within the steering range
    p = tp["P"][rng.integers(1, N, n_points)] + rng.normal(0.0, 0.005, (n_points, ocp.npar))
    return dict(name=name, js=js, ts=ts, jp=jp, tp=tp, jocp=jp["ocp"], tocp=ocp,
                z=z.astype(np.float32), p=p.astype(np.float32))


def close(out, ref, rtol, what):
    """max |out - ref| <= rtol * max |ref|, shapes equal, out finite."""
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, what
    assert np.all(np.isfinite(out)), what
    err = np.abs(out - ref).max()
    assert err <= rtol * max(np.abs(ref).max(), 1e-6), (what, err, np.abs(ref).max())


def check_blocks_equal(case):
    """Registries, bounds and the host halves: the same [N+1, npar] block,
    warm start and xinit, bit for bit."""
    from mpc_planner_tpu_torch import interop

    jocp, tocp = case["jocp"], case["tocp"]
    interop.check_same_registry(jocp.params, tocp.params)
    assert jocp.save_maps() == tocp.save_maps()
    np.testing.assert_array_equal(jocp.lh, tocp.lh)
    np.testing.assert_array_equal(jocp.uh, tocp.uh)
    for key in ("P", "Z0", "xinit"):
        np.testing.assert_array_equal(case["tp"][key], case["jp"][key])


def check_stage_function(case, fn: str, rtol_value: float, rtol_deriv: float):
    """One stage function of the OCP (running_cost, terminal_cost,
    constraint_fn, dynamics_fn) against the JAX package's at the case's
    points: value, and gradient + Hessian (costs) or Jacobian."""
    import jax
    import jax.numpy as jnp
    from torch.func import grad, hessian, jacfwd, vmap

    zj, pj = jnp.asarray(case["z"]), jnp.asarray(case["p"])
    zt, pt = torch.as_tensor(case["z"]), torch.as_tensor(case["p"])
    jf, tf = getattr(case["jocp"], fn), getattr(case["tocp"], fn)
    close(vmap(tf)(zt, pt).numpy(), jax.vmap(jf)(zj, pj), rtol_value, fn)
    if fn.endswith("cost"):
        close(vmap(grad(tf))(zt, pt).numpy(), jax.vmap(jax.grad(jf))(zj, pj), rtol_deriv, fn)
        close(vmap(hessian(tf))(zt, pt).numpy(), jax.vmap(jax.hessian(jf))(zj, pj), rtol_deriv, fn)
    else:
        close(vmap(jacfwd(tf))(zt, pt).numpy(), jax.vmap(jax.jacfwd(jf))(zj, pj), rtol_deriv, fn)


def check_generated_code(case, build_dir: str, rtol: float):
    """The K3 stage code generated for the OCP, built with the host
    compiler, against torch.func in float64 at the same float32 points
    (`rtol` of max |ref| for every output)."""
    import os
    import shutil

    import pytest
    from torch.func import grad, hessian, jacfwd, vmap

    from mpc_planner_tpu_torch.ops.stage_codegen import StageCode, host_evaluator

    cxx = os.environ.get("CXX", "c++")
    if shutil.which(cxx) is None or shutil.which("ninja") is None:
        pytest.skip(f"needs a C++ compiler ({cxx}) and ninja")
    ocp = case["tocp"]
    out = host_evaluator(StageCode(ocp), build_dir)(case["z"], case["p"])
    z, p = torch.as_tensor(case["z"]).double(), torch.as_tensor(case["p"]).double()
    ref = dict(f=vmap(ocp.dynamics_fn)(z, p), Jf=vmap(jacfwd(ocp.dynamics_fn))(z, p),
               g=vmap(grad(ocp.running_cost))(z, p), H=vmap(hessian(ocp.running_cost))(z, p),
               gT=vmap(grad(ocp.terminal_cost))(z, p), HT=vmap(hessian(ocp.terminal_cost))(z, p),
               h=vmap(ocp.constraint_fn)(z, p), Jh=vmap(jacfwd(ocp.constraint_fn))(z, p))
    for name, r in ref.items():
        close(out[name], r.numpy(), rtol, name)


def family_planner_pair(name: str, N: int = N_SMALL, n_pedestrians: int = 6, seed: int = 7,
                        near_pedestrian: bool = True, gap: float = 3.0):
    """Planners of both packages for family `name` (FAMILIES) on the same
    corridor scene (tmpc_planner_pair's): a contouring robot moving at 1 m/s
    behind a pedestrian (`near_pedestrian`; else standing at the origin, the
    KKT ladder's start), a goal-tracking one at the origin with its goal 4 m
    ahead. `gap`: the robot's distance behind the pedestrian."""
    kwargs, edit = FAMILIES[name]
    js, ts = system_pair(N=N, n_pedestrians=n_pedestrians, seed=seed, **kwargs)
    for side in (js, ts):
        if edit is not None:
            edit(side)
        if near_pedestrian and "spline" in side.model.states:
            # 3 m behind the first pedestrian: the obstacle rows are active and
            # the guidance planners' plans differ (no tie for the selection)
            place_near_pedestrian(side.state, side.data, gap=gap, speed=1.0)
            side.state.set("spline", side.state.get("x"))
        side.data.goal = side.state.get_position() + np.array([4.0, 0.5])
        side.data.goal_received = True
    return planner_pair(js, ts)


def planner_cycle(jax_side, torch_side, atol: float = 5e-3):
    """One solve_mpc in both packages: the same outcome and the same plan
    within `atol` (for a guidance planner also the selection record and the
    batch Z, tmpc_cycle). Returns the port's output."""
    if torch_side["module"] is not None and "spline" in torch_side["planner"].model.states:
        return tmpc_cycle(jax_side, torch_side, atol)  # (without a path the guidance stays idle)
    outs = [s["planner"].solve_mpc(s["state"], s["data"]) for s in (jax_side, torch_side)]
    assert outs[1].success == outs[0].success
    np.testing.assert_allclose(torch_side["planner"]._Z, jax_side["planner"]._Z, atol=atol, rtol=0)
    return outs[1]


def advance(side):
    """Move a side's robot to stage 1 of its plan (both packages alike)."""
    planner, state = side["planner"], side["state"]
    for name in planner.model.states:
        state.set(name, planner.get_solution(1, name))
    side["data"].ego_position = state.get_position()
