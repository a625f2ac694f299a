"""The import guard: a run may load nothing of JAX or the JAX package.

Names are compared by their top-level part, the text before the first dot,
as a whole: `mpc_planner_tpu_torch` (the port) begins with `mpc_planner_tpu`
(the JAX package) and is not it.
"""

from __future__ import annotations

import sys
from typing import Iterable, List, Optional

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "mpc_planner_tpu"})


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden_loaded(names: Optional[Iterable[str]] = None) -> List[str]:
    """The loaded module names (default: sys.modules) whose top-level part
    is forbidden, sorted."""
    names = list(sys.modules) if names is None else list(names)
    return sorted(n for n in names if top_level(n) in FORBIDDEN)
