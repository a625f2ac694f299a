"""Derivative code generated for each OCP: the stage functions of the
fused SQP-RTI kernel K3 (ops/csrc/rti_kernel.cuh).

The JAX package differentiates the OCP's stage functions inside its
Pallas kernel with jax.jacfwd / grad / hessian (mpc_planner_tpu/ops/
pallas_rti.py:81-137). A CUDA kernel has no autodiff, so the port
generates the code instead, once per OCP:

  1. each stage function of solver/ocp.py (dynamics, running and
     terminal cost, constraints) is traced with make_fx at one stage's
     shapes (z [nvar], p [npar]) into a small aten graph;
  2. the graph is scalarized: every node has a static shape (its
     meta["val"]), so each tensor becomes an array of C++ scalars;
  3. one C++ function per stage function is emitted, templated over the
     type T of the values that depend on z. Values that depend only on p
     are plain floats; constants are f32 literals (torch computes
     `f32 tensor * python float` in f32). Instantiated with the dual
     numbers of ops/csrc/dual.cuh, Dual<nvar> gives f, df/dz, h and dh/dz,
     Dual2<nvar> the cost's gradient and Hessian.

The kernel runs this straight-line code; it never interprets a graph.
Each output is stored as soon as its value is computed (a constraint row
right after its obstacle's arithmetic), so few dual numbers are alive at
once. An op outside the supported set raises ValueError naming it.

The source is hashed and built at first use with torch.utils.
cpp_extension.load as a plain C library (loaded with ctypes): for sm_90a
into the package's git-ignored `_build/`, with rti_kernel.cuh, for the
card; or with the host compiler, with stage_eval.h, for the CPU test.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import threading

import numpy as np
import torch
from torch.fx.experimental.proxy_tensor import make_fx

from mpc_planner_tpu_torch.ops.cuda_qp import BUILD_DIR, CSRC, load_c_library

_aten = torch.ops.aten

_UNARY = {
    _aten.neg.default: "-({})",
    _aten.reciprocal.default: "mrecip({})",
    _aten.sqrt.default: "msqrt({})",
    _aten.sin.default: "msin({})",
    _aten.cos.default: "mcos({})",
    _aten.sigmoid.default: "msigmoid({})",
    _aten.exp.default: "mexp({})",
    _aten.log.default: "mlog({})",
    _aten.tan.default: "mtan({})",
    _aten.atan.default: "matan({})",
    _aten.erf.default: "merf({})",
    _aten.abs.default: "mabs({})",
}
_BINARY = {
    _aten.add.Tensor: "{} + {}",
    _aten.sub.Tensor: "{} - {}",
    _aten.mul.Tensor: "{} * {}",
    _aten.div.Tensor: "{} / {}",
    _aten.rsub.Scalar: "{1} - {0}",
    _aten.remainder.Scalar: "mrem({}, {})",  # floor mod; the derivative is a's
    _aten.maximum.default: "mmax({}, {})",
    _aten.minimum.default: "mmin({}, {})",
}
# Comparisons give one bool per scalar, evaluated on the value part of a
# dual number (mval); a predicate of p only stays a plain float branch.
_COMPARE = {
    _aten.ge.Scalar: "mval({}) >= {}",
    _aten.gt.Scalar: "mval({}) > {}",
    _aten.lt.Scalar: "mval({}) < {}",
}
_LOGICAL = {
    _aten.bitwise_and.Tensor: "{} && {}",
    _aten.bitwise_not.default: "!{}",
}
_SHAPE_OPS = (_aten.alias.default, _aten.select.int, _aten.slice.Tensor, _aten.stack.default,
              _aten.cat.default, _aten.unsqueeze.default,
              _aten.new_zeros.default, _aten.zeros_like.default, _aten.ones_like.default,
              _aten.scalar_tensor.default, _aten.pow.Tensor_Scalar, _aten.sum.dim_IntList,
              _aten.where.self, _aten.clamp.default)
SUPPORTED_OPS = sorted(str(op) for op in (*_UNARY, *_BINARY, *_COMPARE, *_LOGICAL, *_SHAPE_OPS))


class _Sym:
    """One scalar of the generated code: a C++ expression (a variable, an
    input entry or a literal), whether it depends on z, and whether it is
    a bool (a predicate)."""

    __slots__ = ("code", "dual", "pred")

    def __init__(self, code: str, dual: bool, pred: bool = False):
        self.code = code
        self.dual = dual
        self.pred = pred


class _Param:
    """Entry i of p, loaded into a float the first time it is used."""

    __slots__ = ("i",)

    def __init__(self, i: int):
        self.i = i


def _literal(c) -> str:
    c32 = np.float32(c)
    if not np.isfinite(c32):
        raise ValueError(f"constant {c!r} is not a finite float32")
    text = f"{float(c32)!r}f"
    return f"({text})" if c32 < 0 else text


_ZERO = _Sym("0.0f", False)
_ONE = _Sym("1.0f", False)


def _array(shape, fill) -> np.ndarray:
    out = np.empty(tuple(shape), dtype=object)
    out.fill(fill)
    return out


def _vector(items) -> np.ndarray:
    out = np.empty(len(items), dtype=object)
    out[:] = items
    return out


def _as_array(x) -> np.ndarray:
    """An element or an object array -> an object array (0-d for one)."""
    if isinstance(x, np.ndarray):
        return x
    out = np.empty((), dtype=object)
    out[()] = x
    return out


class _Function:
    """Scalarized emission of one traced stage function."""

    def __init__(self, name: str, fn, nvar: int, npar: int):
        self.name = name
        self.lines = []  # (variable name, C++ statement, variables it reads)
        self.costs = {}  # variable name -> (operation kind, dual operands)
        self.defined = set()
        self.params = {}  # p index -> _Sym of its loaded float
        # a lambda: make_fx does not trace bound methods
        gm = make_fx(lambda z, p: fn(z, p))(torch.zeros(nvar), torch.zeros(npar))
        env = {}
        inputs = iter([_vector([_Sym(f"z[{i}]", True) for i in range(nvar)]),
                       _vector([_Param(i) for i in range(npar)])])
        outputs = None
        for node in gm.graph.nodes:
            if node.op == "placeholder":
                env[node] = next(inputs)
            elif node.op == "call_function":
                env[node] = self._call(node, env)
            elif node.op == "output":
                (out,) = node.args
                if not isinstance(out, torch.fx.Node):
                    raise ValueError(f"{name}: returns {type(out).__name__}, not one tensor")
                outputs = env[out].reshape(-1)
            else:
                raise ValueError(f"{name}: unsupported graph node {node.op} {node.target}")
        self.outputs = [self._scalar(s) for s in outputs]

    # -- scalars -------------------------------------------------------------
    def _var(self, expr: str, dual: bool, *deps: _Sym, pred: bool = False, kind: str = "") -> _Sym:
        name = f"v{len(self.lines)}"
        ctype = "bool" if pred else ("T" if dual else "float")
        self.lines.append((name, f"const {ctype} {name} = {expr};",
                           [d.code for d in deps if d.code in self.defined]))
        # for flops(): the operation and how many of its operands are dual
        self.costs[name] = (kind, sum(d.dual for d in deps))
        self.defined.add(name)
        return _Sym(name, dual, pred)

    def _scalar(self, x) -> _Sym:
        if isinstance(x, _Sym):
            return x
        if isinstance(x, _Param):
            if x.i not in self.params:
                self.params[x.i] = self._var(f"p({x.i})", False)
            return self.params[x.i]
        if isinstance(x, (bool, int, float)):
            return _Sym(_literal(x), False)
        raise ValueError(f"{self.name}: unsupported operand {x!r}")

    def _unary(self, fmt: str, x) -> _Sym:
        s = self._scalar(x)
        return self._var(fmt.format(s.code), s.dual, s, kind="unary")

    def _binary(self, fmt: str, x, y) -> _Sym:
        a, b = self._scalar(x), self._scalar(y)
        if a.pred or b.pred:
            raise ValueError(f"{self.name}: arithmetic on a predicate ({fmt})")
        kind = {"{} * {}": "mul", "{} / {}": "div"}.get(fmt, "add")
        return self._var(fmt.format(a.code, b.code), a.dual or b.dual, a, b, kind=kind)

    def _compare(self, fmt: str, x, c) -> _Sym:
        a = self._scalar(x)
        return self._var(fmt.format(a.code, _literal(c)), False, a, pred=True, kind="compare")

    def _logical(self, fmt: str, *xs) -> _Sym:
        syms = [self._scalar(x) for x in xs]
        if not all(v.pred for v in syms):
            raise ValueError(f"{self.name}: {fmt} on a non-predicate")
        return self._var(fmt.format(*(v.code for v in syms)), False, *syms, pred=True,
                         kind="compare")

    def _where(self, c, x, y) -> _Sym:
        cond, a, b = self._scalar(c), self._scalar(x), self._scalar(y)
        if not cond.pred:
            raise ValueError(f"{self.name}: where on a non-predicate condition")
        if a.dual or b.dual:  # both branches as T: value and derivative of the chosen one
            return self._var(f"{cond.code} ? T({a.code}) : T({b.code})", True, cond, a, b)
        return self._var(f"{cond.code} ? {a.code} : {b.code}", False, cond, a, b)

    def _sum(self, x: np.ndarray, dims, keepdim: bool) -> np.ndarray:
        """Sum over `dims`, left to right."""
        dims = sorted(d % x.ndim for d in ([dims] if isinstance(dims, int) else dims))
        moved = np.moveaxis(x, dims, list(range(x.ndim - len(dims), x.ndim)))
        rest = moved.shape[: x.ndim - len(dims)]
        flat = moved.reshape(rest + (-1,))
        out = _array(rest, None)
        for idx in np.ndindex(*rest):
            acc = flat[idx][0]
            for v in flat[idx][1:]:
                acc = self._binary("{} + {}", acc, v)
            out[idx] = acc
        if keepdim:
            out = np.expand_dims(out, tuple(dims))
        return out

    # -- graph nodes -----------------------------------------------------------
    def _call(self, node, env) -> np.ndarray:
        op = node.target

        def arg(x):
            if isinstance(x, torch.fx.Node):
                return env[x]
            if isinstance(x, (list, tuple)):
                return [arg(v) for v in x]
            return x

        args = [arg(a) for a in node.args]
        placement = ("pin_memory", "device", "dtype", "layout")  # of new_zeros / zeros_like
        kwargs = {k: arg(v) for k, v in node.kwargs.items() if k not in placement}
        val = node.meta.get("val")
        if not isinstance(val, torch.Tensor) or val.dtype not in (torch.float32, torch.bool):
            raise ValueError(f"{self.name}: {op} does not give one float32 or bool tensor")

        if op in _BINARY:
            if kwargs.get("alpha", 1) != 1 or set(kwargs) - {"alpha"}:
                raise ValueError(f"{self.name}: {op} with {kwargs} is not supported")
            fmt = _BINARY[op]
            out = np.frompyfunc(lambda x, y: self._binary(fmt, x, y), 2, 1)(*args)
        elif op in _UNARY:
            fmt = _UNARY[op]
            out = np.frompyfunc(lambda x: self._unary(fmt, x), 1, 1)(args[0])
        elif op in _COMPARE:
            fmt = _COMPARE[op]
            x, c = args
            out = np.frompyfunc(lambda v: self._compare(fmt, v, c), 1, 1)(x)
        elif op in _LOGICAL:
            fmt = _LOGICAL[op]
            out = np.frompyfunc(lambda *v: self._logical(fmt, *v), len(args), 1)(*args)
        elif op is _aten.where.self:
            out = np.frompyfunc(self._where, 3, 1)(*args)
        elif op is _aten.clamp.default:
            # clamp(x, min) only: max_nan keeps NaN, and the derivative passes
            # where x >= min, as torch's
            x, lo, hi = (args + [None, None])[:3]
            if lo is None or hi is not None or kwargs:
                raise ValueError(f"{self.name}: clamp with {args[1:]} {kwargs} is not supported")
            fmt = "mclamp_min({}, " + _literal(lo) + ")"
            out = np.frompyfunc(lambda v: self._unary(fmt, v), 1, 1)(x)
        elif op is _aten.sum.dim_IntList:
            x, dims, keepdim = (args + [None, False])[:3]
            if kwargs or dims is None:
                raise ValueError(f"{self.name}: sum with {args[1:]} {kwargs} is not supported")
            out = self._sum(_as_array(x), dims, keepdim)
        elif op is _aten.pow.Tensor_Scalar:
            # x*x and x*x*x, as torch computes exponents 2 and 3
            x, e = args
            fmt = {2: "msq({})", 3: "mcube({})"}.get(e, "mpow({}, " + _literal(e) + ")")
            out = np.frompyfunc(lambda v: self._unary(fmt, v), 1, 1)(x)
        elif op is _aten.alias.default:
            out = args[0]
        elif op is _aten.select.int:
            x, dim, index = args
            out = np.take(x, index, axis=dim)
        elif op is _aten.slice.Tensor:
            # slice(x, dim=0, start=None, end=None, step=1)
            x, dim, start, end, step = args + [0, None, None, 1][len(args) - 1:]
            index = [slice(None)] * x.ndim
            index[dim] = slice(start, end, step)
            out = x[tuple(index)]
        elif op is _aten.stack.default:
            tensors, dim = (args + [0])[:2]
            out = np.stack([_as_array(t) for t in tensors], axis=dim)
        elif op is _aten.cat.default:
            tensors, dim = (args + [0])[:2]
            out = np.concatenate([_as_array(t) for t in tensors], axis=dim)
        elif op is _aten.unsqueeze.default:
            x, dim = args
            out = np.expand_dims(_as_array(x), dim)
        elif op in (_aten.new_zeros.default, _aten.zeros_like.default):
            out = _array(val.shape, _ZERO)
        elif op is _aten.ones_like.default:
            out = _array(val.shape, _ONE)
        elif op is _aten.scalar_tensor.default:
            out = _Sym(_literal(args[0]), False)
        else:
            raise ValueError(
                f"{self.name}: aten op {op} is not supported by the stage-code generator "
                f"(supported: {', '.join(SUPPORTED_OPS)})")
        out = _as_array(out)
        if out.shape != tuple(val.shape):
            raise ValueError(f"{self.name}: {op} gave shape {out.shape}, traced {tuple(val.shape)}")
        return out

    def _live(self):
        """The variables an output reads, directly or not."""
        live = {s.code for s in self.outputs if s.code in self.defined}
        for name, _, deps in reversed(self.lines):
            if name in live:
                live.update(deps)
        return live

    def flops(self, nvar: int, second_order: bool) -> int:
        """Operations of one evaluation on Dual<nvar> (or Dual2<nvar>)
        numbers, from dual.cuh operator by operator: adds, multiplies and
        divisions count 1 each, a libm call 1, selects and loads 0. A
        statement on plain floats counts 1."""
        n, k = nvar, nvar * (nvar + 1) // 2 if second_order else 0
        parts = 1 + n + k  # value, gradient, packed Hessian
        dual_cost = {
            # (kind, dual operands) -> operations
            ("add", 2): parts, ("add", 1): 1,
            ("mul", 2): 1 + 3 * n + 7 * k, ("mul", 1): parts,
            ("div", 2): 1 + 3 * n + 7 * k, ("div", 1): parts + 3 + 3 * k,  # x / c, or c / x
            ("unary", 1): 4 + n + 4 * k,
        }
        live = self._live()
        return sum(dual_cost.get(self.costs[name], 1 if self.costs[name][0] else 0)
                   for name, _, _ in self.lines if name in live)

    def emit(self) -> str:
        """The C++ member function: out(i, value) for output entry i, each
        right after the statement that computes it; statements no output
        reads are left out."""
        stores, late = {}, []
        for i, s in enumerate(self.outputs):
            if s.code in self.defined:
                stores.setdefault(s.code, []).append(i)
            else:
                late.append(f"out({i}, {s.code});")
        live = self._live()
        body = []
        for name, line, _ in self.lines:
            if name in live:
                body.append(line)
                body += [f"out({i}, {name});" for i in stores.get(name, ())]
        body += late
        lines = [
            "  template <class T, class PA, class Out>",
            f"  static MPC_STAGE void {self.name}(const T* z, const PA& p, const Out& out) {{",
        ]
        lines += [f"    {line}" for line in body]
        lines.append("  }")
        return "\n".join(lines)


def _read(path: str) -> str:
    with open(path) as f:
        return f.read()


def _header_digest() -> str:
    h = hashlib.sha256()
    for path in sorted(glob.glob(os.path.join(CSRC, "*.cuh")) + glob.glob(os.path.join(CSRC, "*.h"))):
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


class StageCode:
    """The generated stage code of one OCP (solver/ocp.py::OCP).

    Construction is cheap; `generate()` traces and emits (once), and raises
    ValueError for a stage function with an unsupported op."""

    def __init__(self, ocp):
        self.ocp = ocp
        self._struct = None
        self._flops = None

    def generate(self) -> str:
        """The `mpc::Stages` struct: dimensions and one templated function
        per stage function. make_fx is not thread-safe: one thread traces
        at a time (builds of other OCPs go on meanwhile)."""
        with _trace_lock:
            return self._generate()

    def _generate(self) -> str:
        if self._struct is None:
            ocp = self.ocp
            fns = [("dynamics", ocp.dynamics_fn), ("running_cost", ocp.running_cost),
                   ("terminal_cost", ocp.terminal_cost)]
            if ocp.nh:
                fns.append(("constraints", ocp.constraint_fn))
            functions = [_Function(name, fn, ocp.nvar, ocp.npar) for name, fn in fns]
            bodies = [f.emit() for f in functions]
            # the costs on Dual2 (gradient and Hessian), the rest on Dual
            self._flops = {f.name: f.flops(ocp.nvar, f.name.endswith("_cost")) for f in functions}
            self._flops.setdefault("constraints", 0)
            if not ocp.nh:  # nh = 0: a constraint function with no rows
                bodies.append("  template <class T, class PA, class Out>\n"
                              "  static MPC_STAGE void constraints(const T*, const PA&, const Out&) {}")
            self._struct = "\n".join([
                "// Generated by mpc_planner_tpu_torch/ops/stage_codegen.py from the stage",
                f"// functions of one OCP ({type(ocp.model).__name__}; modules: "
                f"{', '.join(m.module_name for m in ocp.modules)}). Do not edit.",
                '#include "dual.cuh"',
                "",
                "namespace mpc {",
                "",
                "struct Stages {",
                f"  static constexpr int NU = {ocp.nu}, NX = {ocp.nx}, NP = {ocp.npar}, NH = {ocp.nh};",
                "",
                "\n\n".join(bodies),
                "};",
                "",
                "}  // namespace mpc",
                "",
            ])
        return self._struct

    def flops(self) -> dict:
        """Operations of one evaluation of each stage function with its
        derivatives (K3's linearization calls each once per stage)."""
        self.generate()
        return dict(self._flops)

    def source(self, target: str) -> str:
        """Full translation unit: "cuda" (the K3 kernel) or "cpu" (the
        host evaluation entry of the CPU test)."""
        entry = {"cuda": "rti_kernel.cuh", "cpu": "stage_eval.h"}[target]
        return f'{self.generate()}\n#include "{entry}"\n'


_trace_lock = threading.Lock()
_libs = {}
_build_locks = {}  # one lock per library: different OCPs build in parallel
_libs_lock = threading.Lock()


def load_library(code: StageCode, target: str = "cuda", build_dir: str = BUILD_DIR,
                 verbose: bool = False) -> ctypes.CDLL:
    """Build (once per source, headers and process) and load the generated
    library for `target` ("cuda": sm_90a, "cpu": the host compiler)."""
    src = code.source(target)
    digest = hashlib.sha256((src + _header_digest()).encode()).hexdigest()[:16]
    name = f"mpc_{'rti' if target == 'cuda' else 'stage_eval'}_{digest}"
    key = (name, build_dir)
    with _libs_lock:
        lock = _build_locks.setdefault(key, threading.Lock())
    with lock:
        lib = _libs.get(key)
        if lib is None:
            directory = os.path.join(build_dir, name)
            os.makedirs(directory, exist_ok=True)
            path = os.path.join(directory, "stages.cu" if target == "cuda" else "stages.cpp")
            # rewritten only when it changed: ninja rebuilds on a newer file
            if not os.path.exists(path) or _read(path) != src:
                with open(path, "w") as f:
                    f.write(src)
            lib = load_c_library(name, [path], directory, verbose)
            _libs[key] = lib
    return lib


def host_evaluator(code: StageCode, build_dir: str):
    """Build the generated code with the host compiler and return
    evaluate(z [n, nvar], p [n, npar]) -> dict of numpy arrays: f, Jf
    (dynamics), g, H (running cost), gT, HT (terminal cost, at z as
    given), h, Jh (constraints)."""
    ocp = code.ocp
    fn = load_library(code, "cpu", build_dir).mpc_stage_eval
    fn.restype = None
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 10
    nv, nx, nh = ocp.nvar, ocp.nx, ocp.nh

    def evaluate(z, p):
        z = np.ascontiguousarray(z, dtype=np.float32)
        p = np.ascontiguousarray(p, dtype=np.float32)
        n = z.shape[0]
        out = dict(f=(n, nx), Jf=(n, nx, nv), g=(n, nv), H=(n, nv, nv), gT=(n, nv),
                   HT=(n, nv, nv), h=(n, max(nh, 1)), Jh=(n, max(nh, 1), nv))
        out = {k: np.zeros(s, np.float32) for k, s in out.items()}
        fn(n, z.ctypes.data, p.ctypes.data, *(a.ctypes.data for a in out.values()))
        if not nh:
            out["h"], out["Jh"] = out["h"][:, :0], out["Jh"][:, :0]
        return out

    return evaluate
