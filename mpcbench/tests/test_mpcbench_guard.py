"""The import guard compares top-level names whole, and the reference and
the harness import nothing of JAX, the JAX package or (the reference) the
port."""

import ast
import pathlib

from mpcbench import guard

HERE = pathlib.Path(__file__).resolve().parents[1]


def test_top_level_names_are_compared_whole():
    names = ["mpc_planner_tpu_torch", "mpc_planner_tpu_torch.ops.cuda_rti", "jaxtyping",
             "flaxen", "numpy", "jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
             "mpc_planner_tpu", "mpc_planner_tpu.solver.sqp"]
    assert guard.forbidden_loaded(names) == sorted(
        ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "mpc_planner_tpu",
         "mpc_planner_tpu.solver.sqp"])


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_the_reference_imports_neither_package():
    files = list((HERE / "reference").rglob("*.py"))
    assert len(files) > 20
    for f in files:
        for name in _imports(f):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "mpc_planner_tpu",
                               "mpc_planner_tpu_torch"), (f, name)


def test_the_harness_imports_no_jax():
    for f in HERE.rglob("*.py"):
        if "tests" in f.parts:
            continue
        for name in _imports(f):
            assert name.split(".")[0] not in guard.FORBIDDEN, (f, name)
