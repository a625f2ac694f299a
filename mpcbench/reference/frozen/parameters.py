"""Parameter registry: ordered name -> flat-index mapping per stage.

Counterpart of mpc_planner_tpu/parameters.py (numpy-only, copied so the
port never imports the JAX package). The registry layout is identical, so
both packages exchange the same [N+1, npar] parameter blocks.

The registry is built once while assembling the OCP (module
`define_parameters` calls). At runtime a `ParameterBlock` (a numpy
[N+1, npar] array wrapper) is filled by name/bundle and shipped to the
device in one transfer per cycle. Bundles group indexed parameters
(e.g. ``ellipsoid_obst_{i}_x`` -> bundle ``ellipsoid_obst_x``) so a whole
family is written with one vectorized assignment.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


class ParameterRegistry:
    """Ordered parameter registry (ref util/parameters.py Parameters)."""

    def __init__(self) -> None:
        self._names: List[str] = []
        self._indices: Dict[str, int] = {}
        self._bundles: Dict[str, List[int]] = {}
        self._rqt_params: List[str] = []
        self._frozen = False

    # -- Registration (offline half) ------------------------------------
    def add(
        self,
        name: str,
        bundle_name: Optional[str] = None,
        add_to_rqt_reconfigure: bool = False,
        **_: object,
    ) -> None:
        if self._frozen:
            raise RuntimeError("ParameterRegistry is frozen; cannot add parameters")
        if name in self._indices:
            return  # idempotent like the reference (shared params, e.g. ego_disc_radius)
        idx = len(self._names)
        self._names.append(name)
        self._indices[name] = idx
        if bundle_name is not None:
            self._bundles.setdefault(bundle_name, []).append(idx)
        if add_to_rqt_reconfigure:
            self._rqt_params.append(name)

    def has_parameter(self, name: str) -> bool:
        return name in self._indices

    def freeze(self) -> None:
        self._frozen = True

    # -- Introspection ---------------------------------------------------
    def length(self) -> int:
        return len(self._names)

    @property
    def npar(self) -> int:
        return len(self._names)

    @property
    def names(self) -> Sequence[str]:
        return tuple(self._names)

    def index(self, name: str) -> int:
        return self._indices[name]

    def bundle_indices(self, bundle_name: str) -> np.ndarray:
        return np.asarray(self._bundles[bundle_name], dtype=np.int32)

    def save_map(self) -> Dict[str, int]:
        """name -> index map (the parameter_map.yaml contract)."""
        return dict(self._indices)

    # -- Symbolic access (traced half) ----------------------------------
    def bind(self, p) -> "BoundParams":
        """Bind a per-stage parameter vector (a tensor of length npar,
        possibly under torch.func transforms), returning a read-only view
        with `.get(name)` used by the traced module halves."""
        return BoundParams(self, p)


class BoundParams:
    """Read-only view over (registry, parameter vector)."""

    __slots__ = ("_registry", "_p")

    def __init__(self, registry: ParameterRegistry, p):
        self._registry = registry
        self._p = p

    def get(self, name: str):
        return self._p[self._registry.index(name)]

    def has_parameter(self, name: str) -> bool:
        return self._registry.has_parameter(name)


class ParameterBlock:
    """Host-side [n_stages, npar] parameter array filled by name.

    The extra terminal row holds stage N-1's parameters, matching the
    reference's upload rule (acados_solver_interface.cpp:128-134).
    """

    def __init__(self, registry: ParameterRegistry, n_stages: int):
        self.registry = registry
        self.n_stages = n_stages
        self.data = np.zeros((n_stages, registry.npar), dtype=np.float64)

    def set(self, k: int, name: str, value: float) -> None:
        self.data[k, self.registry.index(name)] = value

    def set_all_stages(self, name: str, value) -> None:
        self.data[:, self.registry.index(name)] = value

    def set_bundle_all_stages(self, bundle_name: str, values) -> None:
        """values: [len(bundle)] or [n_stages, len(bundle)]."""
        idx = self.registry.bundle_indices(bundle_name)
        self.data[:, idx] = values

    def get(self, k: int, name: str) -> float:
        return float(self.data[k, self.registry.index(name)])

    def copy(self) -> "ParameterBlock":
        out = ParameterBlock(self.registry, self.n_stages)
        out.data = self.data.copy()
        return out

    def as_array(self) -> np.ndarray:
        return self.data
