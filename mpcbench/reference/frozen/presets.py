"""The two configurations the benchmark runs, built as the port's presets.py
builds them (ref mpc_planner_jackalsimulator/scripts/
generate_jackalsimulator_solver.py:97-106 and mpc_planner_jackal/scripts/
generate_jackal_solver.py:31-50), from the frozen modules."""

from __future__ import annotations

from mpcbench.reference.frozen.models import ContouringSecondOrderUnicycleModel
from mpcbench.reference.frozen.modules import (
    ContouringModule,
    EllipsoidConstraintModule,
    GoalModule,
    GuidanceConstraintModule,
    ModuleManager,
    MPCBaseModule,
)
from mpcbench.reference.frozen.utils.config import default_config


def _add_base(modules: ModuleManager, cfg) -> MPCBaseModule:
    base = modules.add_module(MPCBaseModule(cfg))
    base.weigh_variable("a", "acceleration")
    base.weigh_variable("w", "angular_velocity")
    if not cfg.contouring.dynamic_velocity_reference:
        base.weigh_variable("v", ["velocity", "reference_velocity"],
                            cost_function=lambda x, w: w[0] * (x - w[1]) ** 2)
    return base


def system_jackalsimulator_tmpc():
    """N=30, dt=0.2, 10 RTI iterations: MPCBase + Contouring + T-MPC++
    guidance with the ellipsoid safety submodule."""
    cfg = default_config(name="jackalsimulator", N=30, integrator_step=0.2)
    if cfg.contouring.dynamic_velocity_reference:
        raise ValueError("the frozen reference has no path reference velocity module")
    modules = ModuleManager()
    model = ContouringSecondOrderUnicycleModel()
    _add_base(modules, cfg)
    modules.add_module(ContouringModule(cfg))
    modules.add_module(GuidanceConstraintModule(cfg, EllipsoidConstraintModule))
    return cfg, model, modules


def system_jackal_goal():
    """N=30, dt=0.2: MPCBase + goal tracking + ellipsoid constraints."""
    cfg = default_config(name="jackal", N=30, integrator_step=0.2)
    modules = ModuleManager()
    model = ContouringSecondOrderUnicycleModel()
    _add_base(modules, cfg)
    modules.add_module(GoalModule(cfg))
    modules.add_module(EllipsoidConstraintModule(cfg))
    return cfg, model, modules


SYSTEMS = {("jackalsimulator", "tmpc"): system_jackalsimulator_tmpc,
           ("jackal", "goal"): system_jackal_goal}


def build(system: str, variant: str):
    """(cfg, model, modules) of a configuration file's system and variant."""
    try:
        return SYSTEMS[(system, variant)]()
    except KeyError:
        raise ValueError(f"the frozen reference does not build {system}/{variant}") from None
