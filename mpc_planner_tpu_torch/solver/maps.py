"""The generated-maps contract: solver_settings / parameter_map / model_map.

Counterpart of mpc_planner_tpu/solver/maps.py. In the reference these
three YAML files let the C++ runtime address the generated solver by name
(generate_solver.py:38-46 writes solver_settings, util/parameters.py:69-74
the parameter map, solver_model.py:118-128 the model map). The port keeps
the name -> index maps on its ParameterRegistry and DynamicsModel and reads
no file at run time; external tooling (log decoders, dashboards) reads
these, and they carry the same keys and values as the reference's for the
same OCP. pyyaml is imported only when the files are written.
"""

from __future__ import annotations

import os
from typing import Dict

from mpc_planner_tpu_torch.solver.ocp import OCP


def solver_settings_map(ocp: OCP) -> Dict:
    """solver_settings.yaml content (ref generate_solver.py:38-46). The
    "solver" value names the reference's solver, so that tooling written
    for its files reads the port's unchanged."""
    settings, _, _ = ocp.save_maps()
    return {**settings, "nh": ocp.nh, "solver": "tpu-sqp"}


def parameter_map(ocp: OCP) -> Dict[str, int]:
    """parameter_map.yaml content: name -> flat per-stage index
    (ref util/parameters.py:69-74)."""
    return ocp.params.save_map()


def model_map(model) -> Dict:
    """model_map.yaml content: var -> [x|u, index, lb, ub]
    (ref solver_model.py:118-128)."""
    return model.save_map()


def save_solver_maps(directory: str, model, ocp: OCP) -> Dict[str, str]:
    """Write the three maps as YAML; returns {name: path}."""
    import yaml

    os.makedirs(directory, exist_ok=True)
    out = {}
    for name, data in (
        ("solver_settings", solver_settings_map(ocp)),
        ("parameter_map", parameter_map(ocp)),
        ("model_map", model_map(model)),
    ):
        path = os.path.join(directory, f"{name}.yaml")
        with open(path, "w") as f:
            yaml.safe_dump(data, f, default_flow_style=None)
        out[name] = path
    return out
