"""AST lint rules over the port's source tree.

The port's counterpart of ``src/repro/analysis/lint.py``: one registry of
source-level invariants and one finding format, shared by the tests and
``python -m repro_torch.analysis.check``.

Step reachability.  The reference's host-sync and nondeterminism rules
look inside jit-traced functions.  The port traces nothing; what matters is
the code that runs on every step: the functions a module names in its
``TRACE_ENTRY_POINTS`` dict (``rk2_step``, ``parallel_fmm_evaluate``, the
service's batched entries) and every module-level function they reference
in the same module, transitively.  Same-module resolution keeps the
analysis local and free of false positives: host-side drivers
(``VortexStepper``, the engine's admission) read device scalars on purpose,
and no entry point reaches them.

The reference's ``StaticArgsRule`` (``static_argnames`` entries must be
parameters, with hashable defaults) has no counterpart: the port has no
``static_argnames``.  Its cache keys are ``functools.lru_cache`` arguments
and ``fmm_service.BucketKey``, which ``analysis/retrace.py`` accounts for.
"""
from __future__ import annotations

import ast
import dataclasses
import pathlib
from typing import Iterable, Optional

__all__ = ["LintFinding", "LintRule", "DEFAULT_RULES", "run_lint",
           "lint_source", "format_findings", "step_reachable_functions",
           "EquationBranchRule", "HostSyncInStepRule",
           "NondeterminismInStepRule", "RebuildTreeOkRule"]


@dataclasses.dataclass(frozen=True)
class LintFinding:
    rule: str
    path: str
    line: int
    message: str

    def __str__(self):
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


class LintRule:
    name = "lint-rule"
    # None = every file; else only paths whose tail matches one entry
    applies_to: Optional[tuple] = None

    def check(self, tree: ast.AST, src: str, path: str) -> list:
        raise NotImplementedError

    def _find(self, path: str, node: ast.AST, message: str) -> LintFinding:
        return LintFinding(self.name, path, getattr(node, "lineno", 0),
                           message)

    def applies(self, path: str) -> bool:
        if self.applies_to is None:
            return True
        norm = path.replace("\\", "/")
        return any(norm.endswith(tail) for tail in self.applies_to)


# ---------------------------------------------------------------------------
# step reachability (shared by the in-step rules)
# ---------------------------------------------------------------------------


def _entry_point_names(tree: ast.AST) -> list:
    """The function names a module lists as values of its
    ``TRACE_ENTRY_POINTS = {...}`` dict."""
    names = []
    for node in tree.body:
        target = node.target if isinstance(node, ast.AnnAssign) else (
            node.targets[0] if isinstance(node, ast.Assign) and
            len(node.targets) == 1 else None)
        if isinstance(target, ast.Name) and target.id == "TRACE_ENTRY_POINTS" \
                and isinstance(node.value, ast.Dict):
            names += [v.id for v in node.value.values if isinstance(v, ast.Name)]
    return names


def step_reachable_functions(tree: ast.AST) -> dict:
    """{name: FunctionDef} of module-level functions reachable from the
    module's ``TRACE_ENTRY_POINTS`` in the same module (roots included)."""
    funcs = {n.name: n for n in tree.body
             if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    reachable, frontier = set(), [n for n in _entry_point_names(tree)
                                  if n in funcs]
    while frontier:
        name = frontier.pop()
        if name in reachable:
            continue
        reachable.add(name)
        # any Name reference counts as an edge: direct calls, and functions
        # handed on as values (functools.partial, callbacks)
        for node in ast.walk(funcs[name]):
            if isinstance(node, ast.Name) and node.id in funcs \
                    and node.id != name:
                frontier.append(node.id)
    return {name: funcs[name] for name in reachable}


def _attr_tail(node: ast.AST) -> str:
    return node.attr if isinstance(node, ast.Attribute) else (
        node.id if isinstance(node, ast.Name) else "")


def _attr_root(node: ast.AST) -> str:
    while isinstance(node, ast.Attribute):
        node = node.value
    return node.id if isinstance(node, ast.Name) else ""


# tensor methods whose result is still a tensor on the device
_TENSOR_METHODS = frozenset({"sum", "max", "min", "mean", "all", "any", "norm",
                             "abs", "amax", "amin", "prod", "count_nonzero"})


def _expr_touches_tensors(node: ast.AST) -> bool:
    """Heuristic: the expression calls ``torch.``/``F.`` or a tensor
    reduction method, so it makes a device tensor, and a Python cast of it
    copies the value to the host (static host data, such as a plan's rows or
    a shape, is fine)."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute) and _attr_root(sub) in ("torch", "F"):
            return True
        if isinstance(sub, ast.Call) and isinstance(sub.func, ast.Attribute) \
                and sub.func.attr in _TENSOR_METHODS:
            return True
    return False


# ---------------------------------------------------------------------------
# the rules
# ---------------------------------------------------------------------------


class EquationBranchRule(LintRule):
    """Drivers and kernels consume ONLY the EquationSpec: no comparisons
    against equation names and no isinstance checks on concrete equation
    classes in the slab-path files."""

    name = "no-equation-branches"
    applies_to = ("core/fmm.py", "core/parallel_fmm.py", "kernels/ops.py",
                  "kernels/m2l.py", "kernels/p2p.py")
    _names = frozenset({"vortex", "laplace", "tracer"})

    def check(self, tree, src, path):
        out = []
        for node in ast.walk(tree):
            if isinstance(node, ast.Compare):
                sides = [node.left] + list(node.comparators)
                for s in sides:
                    if isinstance(s, ast.Constant) and s.value in self._names:
                        out.append(self._find(
                            path, node, f"comparison against equation name "
                            f"{s.value!r}; dispatch through the spec"))
                        break
                else:
                    if any(_attr_tail(s) == "name" and
                           isinstance(s, ast.Attribute) and
                           _attr_tail(s.value) == "eq" for s in sides):
                        out.append(self._find(
                            path, node, "branch on eq.name; use the spec's "
                            "hooks instead"))
            if isinstance(node, ast.Call) and \
                    _attr_tail(node.func) == "isinstance" and \
                    len(node.args) == 2:
                tail = _attr_tail(node.args[1])
                if tail.endswith("Equation"):
                    out.append(self._find(
                        path, node, f"isinstance({tail}) in a driver; "
                        "the slab path must be spec-generic"))
        return out


class HostSyncInStepRule(LintRule):
    """No host syncs on the step path: ``.item()``, ``.cpu()``,
    ``.tolist()``, ``.numpy()``, ``torch.cuda.synchronize()``, or
    ``float()``/``int()``/``bool()`` of an expression that makes a tensor,
    in a function reachable from ``TRACE_ENTRY_POINTS``.  Each stops the
    host until the card has drained its queue."""

    name = "no-host-sync-in-step"
    _methods = frozenset({"item", "cpu", "tolist", "numpy"})
    _casts = frozenset({"float", "int", "bool", "complex"})

    def check(self, tree, src, path):
        out = []
        for fname, fn in step_reachable_functions(tree).items():
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                tail = _attr_tail(node.func)
                if tail in self._methods and isinstance(node.func, ast.Attribute) \
                        and _attr_root(node.func) not in ("np", "numpy"):
                    out.append(self._find(
                        path, node, f".{tail}() in step-path {fname}(): "
                        f"forces a host sync"))
                elif tail == "synchronize" and _attr_root(node.func) == "torch":
                    out.append(self._find(
                        path, node, f"torch.cuda.synchronize in step-path "
                        f"{fname}()"))
                elif isinstance(node.func, ast.Name) and tail in self._casts \
                        and node.args and _expr_touches_tensors(node.args[0]):
                    out.append(self._find(
                        path, node, f"{tail}() around a tensor expression in "
                        f"step-path {fname}(): host sync"))
        return out


class NondeterminismInStepRule(LintRule):
    """No ambient nondeterminism on the step path: wall-clock reads
    (``time.time``, ``perf_counter``, ``datetime.now``), the ``random``
    module, the global numpy RNG (``np.random.*``) and torch's random
    calls without ``generator=``.  A step that reads them gives another
    result on every run and breaks the bit-for-bit restore."""

    name = "no-nondeterminism-in-step"
    _clock = frozenset({"now", "time", "perf_counter", "monotonic",
                        "time_ns", "utcnow", "perf_counter_ns"})
    _torch_random = frozenset({"rand", "randn", "randint", "randperm",
                               "rand_like", "randn_like", "randint_like",
                               "normal", "bernoulli", "multinomial", "poisson",
                               "uniform_", "normal_", "random_", "exponential_",
                               "bernoulli_", "cauchy_", "geometric_",
                               "log_normal_"})

    def check(self, tree, src, path):
        out = []
        for fname, fn in step_reachable_functions(tree).items():
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                tail = _attr_tail(node.func)
                func = node.func
                root = _attr_root(func)
                if tail in self._clock and root in ("time", "datetime", ""):
                    out.append(self._find(
                        path, node, f"{tail}() in step-path {fname}(): a wall "
                        f"clock read"))
                elif isinstance(func, ast.Attribute) and \
                        _attr_tail(func.value) == "random" and \
                        _attr_root(func.value) in ("np", "numpy"):
                    out.append(self._find(
                        path, node, f"np.random.{tail}() in step-path "
                        f"{fname}(): the global numpy RNG"))
                elif isinstance(func, ast.Attribute) and \
                        isinstance(func.value, ast.Name) and func.value.id == "random":
                    out.append(self._find(
                        path, node, f"random.{tail}() in step-path {fname}()"))
                elif tail in self._torch_random and \
                        (root == "torch" or tail.endswith("_")) and \
                        not any(k.arg == "generator" for k in node.keywords):
                    out.append(self._find(
                        path, node, f"{tail}() without generator= in step-path "
                        f"{fname}(): torch's global RNG"))
        return out


class RebuildTreeOkRule(LintRule):
    """``rebuild_tree`` silently drops particles on leaf overflow and
    reports it only through its third output: every call site must bind
    all three results and give the ok flag a real name."""

    name = "rebuild-tree-ok-consumed"

    def check(self, tree, src, path):
        out = []
        for node in ast.walk(tree):
            if not isinstance(node, ast.Assign):
                continue
            call = node.value
            if not (isinstance(call, ast.Call) and
                    _attr_tail(call.func) == "rebuild_tree"):
                continue
            tgt = node.targets[0]
            names = [e.id for e in tgt.elts
                     if isinstance(e, ast.Name)] \
                if isinstance(tgt, ast.Tuple) else []
            if not isinstance(tgt, ast.Tuple) or len(tgt.elts) != 3:
                out.append(self._find(
                    path, node, "rebuild_tree call must unpack "
                    "(tree, aux, ok)"))
            elif not names or names[-1] in ("_", "__"):
                out.append(self._find(
                    path, node, "rebuild_tree's ok flag is discarded; "
                    "overflow drops would be silent"))
        return out


DEFAULT_RULES = (EquationBranchRule(), HostSyncInStepRule(),
                 NondeterminismInStepRule(), RebuildTreeOkRule())


# ---------------------------------------------------------------------------
# drivers
# ---------------------------------------------------------------------------


def lint_source(src: str, path: str = "<string>",
                rules: Iterable[LintRule] = DEFAULT_RULES) -> list:
    """Lint one source string (tests plant violations this way)."""
    tree = ast.parse(src)
    out = []
    for rule in rules:
        if rule.applies(path):
            out.extend(rule.check(tree, src, path))
    return out


def run_lint(root, rules: Iterable[LintRule] = DEFAULT_RULES) -> list:
    """Lint every ``*.py`` under ``root`` (a directory or a single file).
    Findings are sorted by (path, line) for stable output."""
    root = pathlib.Path(root)
    paths = [root] if root.is_file() else sorted(root.rglob("*.py"))
    findings = []
    for p in paths:
        try:
            src = p.read_text()
        except (OSError, UnicodeDecodeError):
            continue
        findings.extend(lint_source(src, str(p), rules))
    return sorted(findings, key=lambda f: (f.path, f.line))


def format_findings(findings) -> str:
    if not findings:
        return "lint: clean"
    return "\n".join([f"lint: {len(findings)} finding(s)"] +
                     [f"  {f}" for f in findings])
