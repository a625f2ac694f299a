"""The port stands alone: no module of mpc_planner_tpu_torch and no line of
chip_smoke.py imports JAX, jaxlib, chex or the JAX package
(mpc_planner_tpu), and importing every module of the port leaves jax out
of sys.modules. The machine with the card has no JAX at all."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "mpc_planner_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "chex", "mpc_planner_tpu")


def _sources():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(PORT):
        files += [os.path.join(dirpath, n) for n in sorted(names) if n.endswith(".py")]
    return files


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
              and node.func.attr == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_no_forbidden_import_in_the_source():
    bad = []
    files = _sources()
    assert len(files) > 40
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), filename=path)
        for name in _imports(tree):
            if name.split(".")[0] in FORBIDDEN:
                bad.append(f"{os.path.relpath(path, ROOT)}: import {name}")
    assert not bad, "\n".join(bad)


def test_guard_catches_a_forbidden_import():
    tree = ast.parse("import os\nfrom mpc_planner_tpu.solver import qp\nimport jax.numpy as jnp\n"
                     "from mpc_planner_tpu_torch import planner\n")
    names = [n for n in _imports(tree) if n.split(".")[0] in FORBIDDEN]
    assert names == ["mpc_planner_tpu.solver", "jax.numpy"]


@pytest.mark.parametrize("extra", ["", "import chip_smoke"])
def test_importing_every_module_leaves_jax_out(extra):
    script = f"""
import importlib, pkgutil, sys
import mpc_planner_tpu_torch
{extra}
names = [m.name for m in pkgutil.walk_packages(mpc_planner_tpu_torch.__path__, "mpc_planner_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m.split(".")[0] in {FORBIDDEN!r})
assert not bad, bad
print(len(names))
"""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          timeout=300, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.split()[-1]) > 40
