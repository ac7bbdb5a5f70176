"""AST-based capture-safety lint of the port (``repro/analysis/lint.py``,
translated from jax/Pallas to PyTorch and CUDA graphs).

  PYTHONPATH=src python -m repro_torch.analysis.lint [paths...]

(default ``src/repro_torch``) exits non-zero while any unwaived finding
remains. Generic style linting belongs to ``ruff``; this pass carries the
domain rules, hazards that are legal Python but wrong (or silently costly)
in the port's compiled context: the functions that run under CUDA-graph
capture, the step a ``serving.capture.CapturedStep`` captures (its first
argument) and any function called inside a ``with StepGuard(...)`` or
``with torch.cuda.graph(...)`` block.

  PUL101 traced-branch       Python ``if``/``while`` on a device tensor's
                             value: the capture bakes one branch into the
                             graph (and reads the tensor back to decide).
                             Use ``torch.where``. Outside the captured
                             context, as in the reference, a parameter
                             annotated ``torch.Tensor`` (and what derives
                             from it) counts too.
  PUL102 host-sync           ``.item()`` / ``.tolist()`` / ``.cpu()`` /
                             ``.numpy()`` / ``float()`` / ``int()`` /
                             ``bool()`` / ``np.asarray()`` on a device
                             tensor in the captured context: a device sync
                             that a CUDA graph cannot hold (``StepGuard``
                             refuses it at run time; this finds it before).
  PUL104 mutable-default     Mutable default argument. As the reference.
  PUL105 swallowed-exception Bare ``except:`` / ``except BaseException``
                             without re-raise, or a silent ``except
                             Exception``. As the reference.
  PUL106 unbalanced-span     Unequal ``.begin_span(`` / ``.end_span(``
                             counts within one function scope. As the
                             reference.
  PUL107 copied-update       An out-of-place indexed update
                             (``x.index_put(...)``, ``x.scatter(...)``,
                             ``x.index_copy(...)``, ...) of a parameter of a
                             captured step: it copies the whole buffer on
                             every replay, the torch form of the reference's
                             ``x.at[...].set`` on an undonated jit input.
                             Update the buffer in place (the ``_`` form), as
                             a plane of the captured step.

PUL103 (a ``pl.BlockSpec`` block shape built from a traced value) is
dropped: the port has no BlockSpec. Its kernels' tiles are template
parameters of the CUDA sources, and a launch's geometry is computed on the
host from shapes and passed through ctypes as integers
(``kernels/_runtime.SIGNATURES``), so there is no traced value for a block
shape to come from.

Traced-vs-host classification is annotation-driven, as in the reference: a
parameter annotated ``torch.Tensor`` is traced; any other annotation
(``int``, ``np.ndarray``, config dataclasses, ...) is host. Unannotated
parameters are traced ONLY inside the captured context. Static accessors
(``x.shape``, ``x.dtype``, ``x.device``, ``x.size()``, ``x.dim()``,
``x.numel()``, ``x.data_ptr()``, ``len(x)``, ``isinstance(x, ...)``,
``is_dtensor(x)``, ``x is None``) never count as traced uses: shapes,
types and addresses are fixed in a captured graph.

Waive a true-but-intended finding with an inline comment on the flagged
line: ``# pul-lint: disable=PUL101`` (comma-separated list, or ``all``).
"""
from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

RULES: Dict[str, str] = {
    "PUL101": "Python branch on a device tensor in a captured context",
    "PUL102": "host sync on a device tensor in a captured context",
    "PUL104": "mutable default argument",
    "PUL105": "swallowed exception",
    "PUL106": "unbalanced tracer span begin/end",
    "PUL107": "out-of-place update of a captured step's input",
}

_WAIVER_RE = re.compile(r"#\s*pul-lint:\s*disable=([A-Za-z0-9,_\s]+|all)")

# annotations that mean "this value is a device tensor"
_TRACED_ANNOTATIONS = {"torch.Tensor", "Tensor"}
# attribute reads (and method calls) that are static in a captured graph
# (never a traced *use*)
_STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "layout", "is_cuda",
                 "requires_grad", "size", "dim", "numel", "element_size",
                 "is_floating_point", "is_contiguous", "stride",
                 "data_ptr"}
# calls whose result is host-static regardless of traced arguments
_STATIC_CALLS = {"len", "isinstance", "type", "hasattr", "getattr", "id",
                 "repr", "str", "is_dtensor", "torch.is_tensor"}
# module prefixes whose call results are device tensors in a captured
# context, and the calls of them that are not
_ARRAY_MODULES = ("torch", "F")
_HOST_ARRAY_CALLS = {"torch.device", "torch.Size", "torch.is_tensor",
                     "torch.is_grad_enabled", "torch.is_floating_point",
                     "torch.finfo", "torch.iinfo", "torch.get_default_dtype"}
_HOST_SYNC_METHODS = {"item", "tolist", "cpu", "numpy", "synchronize"}
_HOST_SYNC_CALLS = {"float", "int", "bool", "complex"}
_NUMPY_SYNC_CALLS = {"np.asarray", "np.array", "numpy.asarray",
                     "numpy.array", "onp.asarray", "onp.array"}
# what puts a function in the captured context: its name passed first to
# one of these, or called inside a `with` over one of _CAPTURE_BLOCKS
_CAPTURE_WRAPPERS = {"CapturedStep", "capture.CapturedStep",
                     "torch.cuda.make_graphed_callables",
                     "make_graphed_callables"}
_CAPTURE_BLOCKS = {"StepGuard", "capture.StepGuard", "torch.cuda.graph"}
# out-of-place indexed updates: a full copy of the base buffer per call
_COPY_UPDATE_METHODS = {"index_put", "index_add", "index_copy", "index_fill",
                        "index_reduce", "scatter", "scatter_add",
                        "scatter_reduce", "masked_fill", "masked_scatter",
                        "put", "diagonal_scatter", "select_scatter",
                        "slice_scatter"}


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str
    line: int
    col: int
    message: str

    def describe(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"


def _dotted(node: ast.AST) -> Optional[str]:
    """'torch.cuda.graph' for Attribute/Name chains, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _annotation_name(node: Optional[ast.AST]) -> Optional[str]:
    if node is None:
        return None
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.Subscript):        # Optional[torch.Tensor] etc.
        return _annotation_name(node.slice)
    return _dotted(node)


def _is_traced_annotation(node: Optional[ast.AST]) -> bool:
    name = _annotation_name(node)
    return name is not None and name in _TRACED_ANNOTATIONS


class _TracedUses(ast.NodeVisitor):
    """Collect *dynamic* uses of traced names inside one expression.

    A traced name consumed only through static accessors (``x.shape``,
    ``len(x)``, ``x is None``) contributes nothing — those are resolved at
    trace time and are safe in Python control flow.
    """

    def __init__(self, traced: Set[str]):
        self.traced = traced
        self.uses: List[ast.Name] = []

    def visit_Name(self, node: ast.Name) -> None:
        if node.id in self.traced:
            self.uses.append(node)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if node.attr in _STATIC_ATTRS:
            return                      # x.shape / x.dtype: static
        self.visit(node.value)

    def visit_Call(self, node: ast.Call) -> None:
        name = _dotted(node.func)
        if name in _STATIC_CALLS:
            return                      # len(x), isinstance(x, ...): static
        if name in _HOST_SYNC_CALLS or (
                isinstance(node.func, ast.Attribute)
                and node.func.attr in _HOST_SYNC_METHODS):
            return                      # float(x) / x.item(): the RESULT is
                                        # a host scalar (the sync itself is
                                        # PUL102's business, under capture)
        self.generic_visit(node)

    def visit_Compare(self, node: ast.Compare) -> None:
        if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
            return                      # `x is None`: trace-time identity
        self.generic_visit(node)

    def visit_Lambda(self, node: ast.Lambda) -> None:
        return                          # separate scope, analyzed on its own


def _dynamic_uses(expr: ast.AST, traced: Set[str]) -> List[ast.Name]:
    v = _TracedUses(traced)
    v.visit(expr)
    return v.uses


def _expr_is_traced(expr: ast.AST, traced: Set[str], in_capture: bool) -> bool:
    """Does evaluating `expr` yield a device tensor?"""
    if _dynamic_uses(expr, traced):
        return True
    if in_capture and isinstance(expr, ast.Call):
        name = _dotted(expr.func) or ""
        head = name.split(".", 1)[0]
        if head in _ARRAY_MODULES and name not in _HOST_ARRAY_CALLS:
            return True                 # torch.zeros(...) etc. -> tensor
    return False


class _FunctionLinter:
    """Lint one function body (not recursing into nested scopes)."""

    def __init__(self, fn, *, path: str, in_capture: bool,
                 findings: List[Finding]):
        self.fn = fn
        self.path = path
        self.in_capture = in_capture
        self.findings = findings
        args = fn.args
        self.param_names = {
            a.arg for a in (list(args.posonlyargs) + list(args.args)
                            + list(args.kwonlyargs))
            if a.arg not in ("self", "cls")}
        self.traced = self._initial_traced(fn)

    # -------------------------------------------------------------- #
    def _initial_traced(self, fn) -> Set[str]:
        traced: Set[str] = set()
        args = fn.args
        positional = list(args.posonlyargs) + list(args.args)
        for a in positional:
            if _is_traced_annotation(a.annotation):
                traced.add(a.arg)
            elif (a.annotation is None and self.in_capture
                  and a.arg not in ("self", "cls")):
                traced.add(a.arg)       # conservative fallback, capture only
        # keyword-only params are static knobs unless annotated otherwise
        for a in args.kwonlyargs:
            if _is_traced_annotation(a.annotation):
                traced.add(a.arg)
        return traced

    def _flag(self, rule: str, node: ast.AST, message: str) -> None:
        self.findings.append(Finding(
            rule=rule, path=self.path, line=node.lineno,
            col=node.col_offset, message=message))

    # -------------------------------------------------------------- #
    def run(self) -> None:
        body = self.fn.body if not isinstance(self.fn, ast.Lambda) \
            else [ast.Expr(value=self.fn.body)]
        for stmt in body:
            self._visit_stmt(stmt)

    def _visit_stmt(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return                      # nested scope: handled separately
        if isinstance(stmt, ast.Assign):
            if _expr_is_traced(stmt.value, self.traced, self.in_capture):
                for tgt in stmt.targets:
                    for name in ast.walk(tgt):
                        if isinstance(name, ast.Name):
                            self.traced.add(name.id)
            self._visit_expr(stmt.value)
        elif isinstance(stmt, ast.AnnAssign):
            if stmt.value is not None:
                if (_is_traced_annotation(stmt.annotation)
                        or _expr_is_traced(stmt.value, self.traced,
                                           self.in_capture)):
                    if isinstance(stmt.target, ast.Name):
                        self.traced.add(stmt.target.id)
                self._visit_expr(stmt.value)
        elif isinstance(stmt, ast.AugAssign):
            self._visit_expr(stmt.value)
        elif isinstance(stmt, (ast.If, ast.While)):
            self._check_branch(stmt)
            self._visit_expr(stmt.test)
            for s in stmt.body + stmt.orelse:
                self._visit_stmt(s)
        elif isinstance(stmt, ast.For):
            if _expr_is_traced(stmt.iter, self.traced, self.in_capture):
                for name in ast.walk(stmt.target):
                    if isinstance(name, ast.Name):
                        self.traced.add(name.id)
            self._visit_expr(stmt.iter)
            for s in stmt.body + stmt.orelse:
                self._visit_stmt(s)
        elif isinstance(stmt, ast.Try):
            for s in (stmt.body + stmt.orelse + stmt.finalbody
                      + [h for hh in stmt.handlers for h in hh.body]):
                self._visit_stmt(s)
        elif isinstance(stmt, ast.With):
            for s in stmt.body:
                self._visit_stmt(s)
        elif isinstance(stmt, (ast.Return, ast.Expr)):
            if stmt.value is not None:
                self._visit_expr(stmt.value)
        # other statements (pass, raise, etc.): nothing traced to track

    # -------------------------------------------------------------- #
    def _check_branch(self, stmt) -> None:
        # outside the captured context `self.traced` only holds
        # annotation-traced names (and values derived from them), so host
        # code that branches on genuinely-host values is never flagged
        uses = _dynamic_uses(stmt.test, self.traced)
        if uses:
            kind = "if" if isinstance(stmt, ast.If) else "while"
            names = ", ".join(sorted({u.id for u in uses}))
            self._flag("PUL101", stmt,
                       f"`{kind}` on device tensor(s) {names}: a captured "
                       "graph keeps one branch, and deciding reads the "
                       "device back (use torch.where)")

    def _visit_expr(self, expr: ast.AST) -> None:
        for node in ast.walk(expr):
            if isinstance(node, ast.Call):
                self._check_call(node)

    def _check_call(self, call: ast.Call) -> None:
        if not self.in_capture:
            return
        name = _dotted(call.func)
        self._check_copied_update(call)
        # PUL102: host syncs on device tensors
        if (isinstance(call.func, ast.Attribute)
                and call.func.attr in _HOST_SYNC_METHODS
                and _expr_is_traced(call.func.value, self.traced, False)):
            self._flag("PUL102", call,
                       f".{call.func.attr}() on a device tensor syncs with "
                       "the host inside the captured step")
            return
        if name in _HOST_SYNC_CALLS and call.args and \
                _dynamic_uses(call.args[0], self.traced):
            self._flag("PUL102", call,
                       f"{name}() on a device tensor reads it back to the "
                       "host inside the captured step")
        elif name in _NUMPY_SYNC_CALLS and call.args and \
                _dynamic_uses(call.args[0], self.traced):
            self._flag("PUL102", call,
                       f"{name}() on a device tensor pulls it to host "
                       "memory inside the captured step")

    def _check_copied_update(self, call: ast.Call) -> None:
        """PUL107: `x.index_put(...)` (or another out-of-place indexed
        update) where `x` is a parameter of the captured step: every replay
        copies the whole of `x`. The in-place form (`x.index_put_(...)`)
        writes the captured buffer itself."""
        if not (isinstance(call.func, ast.Attribute)
                and call.func.attr in _COPY_UPDATE_METHODS
                and isinstance(call.func.value, ast.Name)):
            return                      # only bare-name bases: `x.scatter`
        base = call.func.value.id
        if base in self.param_names:
            self._flag("PUL107", call,
                       f"`{base}.{call.func.attr}(...)` copies a captured "
                       "step's input on every replay: update it in place "
                       f"(`{base}.{call.func.attr}_(...)`) as a plane of the "
                       "captured step, or build the value inside the step")


# ------------------------------------------------------------------ #
# module-level pass
# ------------------------------------------------------------------ #
def _last(name: Optional[str]) -> Optional[str]:
    """The function name of a dotted reference (`self._step` -> `_step`)."""
    return name.rsplit(".", 1)[-1] if name else None


class _ModuleLinter(ast.NodeVisitor):
    def __init__(self, tree: ast.Module, path: str):
        self.tree = tree
        self.path = path
        self.findings: List[Finding] = []
        self.capture_names = self._collect_capture_names(tree)

    # -------------------------------------------------------------- #
    def _collect_capture_names(self, tree: ast.Module) -> Set[str]:
        """Names of functions that run under capture: passed first to a
        capture wrapper (resolving one level of `x = functools.partial(f,
        ...)` aliasing), or called inside a `with` over a capture block."""
        alias: Dict[str, str] = {}

        def _resolve_partial(call: ast.Call) -> Optional[str]:
            fname = _dotted(call.func)
            if fname in ("functools.partial", "partial") and call.args:
                return _dotted(call.args[0])
            return None

        for node in ast.walk(tree):
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and isinstance(node.value, ast.Call)):
                resolved = _resolve_partial(node.value)
                if resolved:
                    alias[node.targets[0].id] = resolved
        names: Set[str] = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) and _dotted(
                    node.func) in _CAPTURE_WRAPPERS:
                for arg in node.args[:1]:
                    target = _dotted(arg)
                    if target is None and isinstance(arg, ast.Call):
                        target = _resolve_partial(arg)
                    elif target is not None and target in alias:
                        target = alias[target]
                    if target is not None:
                        names.add(_last(target))
            elif isinstance(node, ast.With) and any(
                    isinstance(item.context_expr, ast.Call)
                    and _dotted(item.context_expr.func) in _CAPTURE_BLOCKS
                    for item in node.items):
                for stmt in node.body:
                    for call in ast.walk(stmt):
                        if isinstance(call, ast.Call):
                            target = _dotted(call.func)
                            names.add(_last(alias.get(target, target)))
        names.discard(None)
        return names

    def _is_capture_context(self, fn) -> bool:
        if isinstance(fn, ast.Lambda):
            return False                # handled at the wrapper call sites
        return fn.name in self.capture_names

    # -------------------------------------------------------------- #
    def run(self) -> List[Finding]:
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._lint_function(node)
                self._check_mutable_defaults(node)
                self._check_span_balance(node)
            elif isinstance(node, ast.Try):
                self._check_handlers(node)
        # lambdas passed straight into capture wrappers
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Call) and _dotted(
                    node.func) in _CAPTURE_WRAPPERS:
                for arg in node.args[:1]:
                    if isinstance(arg, ast.Lambda):
                        _FunctionLinter(arg, path=self.path, in_capture=True,
                                        findings=self.findings).run()
        return self.findings

    def _lint_function(self, fn) -> None:
        _FunctionLinter(fn, path=self.path,
                        in_capture=self._is_capture_context(fn),
                        findings=self.findings).run()

    # -------------------------------------------------------------- #
    def _check_mutable_defaults(self, fn) -> None:
        defaults = list(fn.args.defaults) + [
            d for d in fn.args.kw_defaults if d is not None]
        for d in defaults:
            mutable = isinstance(d, (ast.List, ast.Dict, ast.Set,
                                     ast.ListComp, ast.DictComp, ast.SetComp))
            if isinstance(d, ast.Call) and _dotted(d.func) in (
                    "list", "dict", "set", "bytearray"):
                mutable = True
            if mutable:
                self.findings.append(Finding(
                    rule="PUL104", path=self.path, line=d.lineno,
                    col=d.col_offset,
                    message=f"mutable default argument in {fn.name}(): "
                            "shared across calls; use None + in-body init"))

    def _check_span_balance(self, fn) -> None:
        """PUL106: `.begin_span(` / `.end_span(` counts must balance within
        one function scope (nested defs/lambdas are their own scopes).
        Async spans (`async_begin`/`async_end`) pair by id across scopes by
        design and are exempt."""
        begins = ends = 0
        first: Optional[ast.Call] = None
        stack: List[ast.AST] = list(fn.body)
        while stack:
            node = stack.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                continue                # separate scope, checked on its own
            if isinstance(node, ast.Call) and isinstance(node.func,
                                                         ast.Attribute):
                if node.func.attr == "begin_span":
                    begins += 1
                    first = first or node
                elif node.func.attr == "end_span":
                    ends += 1
                    first = first or node
            stack.extend(ast.iter_child_nodes(node))
        if begins != ends:
            anchor = first if first is not None else fn
            self.findings.append(Finding(
                rule="PUL106", path=self.path, line=anchor.lineno,
                col=anchor.col_offset,
                message=f"{fn.name}() opens {begins} sync span(s) but "
                        f"closes {ends}: an exception in between leaves the "
                        "trace's B/E stack open. Use `with tracer.span("
                        "...)`; cross-scope work belongs on async spans"))

    def _check_handlers(self, node: ast.Try) -> None:
        for h in node.handlers:
            caught = _dotted(h.type) if h.type is not None else None
            broad_base = h.type is None or caught == "BaseException"
            catches_exc = caught == "Exception"
            if not (broad_base or catches_exc):
                continue
            has_raise = any(isinstance(n, ast.Raise)
                            for n in ast.walk(ast.Module(body=h.body,
                                                         type_ignores=[])))
            if broad_base and not has_raise:
                what = "bare except" if h.type is None \
                    else "except BaseException"
                self.findings.append(Finding(
                    rule="PUL105", path=self.path, line=h.lineno,
                    col=h.col_offset,
                    message=f"{what} without re-raise swallows "
                            "KeyboardInterrupt/SystemExit; catch Exception "
                            "or re-raise"))
            elif catches_exc and not has_raise and not self._uses_exc(h):
                self.findings.append(Finding(
                    rule="PUL105", path=self.path, line=h.lineno,
                    col=h.col_offset,
                    message="except Exception swallowed silently (no "
                            "re-raise, exception never inspected/logged); "
                            "name the expected exception or log it"))

    @staticmethod
    def _uses_exc(h: ast.ExceptHandler) -> bool:
        if h.name is None:
            # no binding: the handler can still log via traceback/logging
            return any(
                isinstance(n, ast.Call) and (_dotted(n.func) or "").split(
                    ".")[0] in ("traceback", "logging", "log", "warnings")
                for n in ast.walk(ast.Module(body=h.body, type_ignores=[])))
        return any(isinstance(n, ast.Name) and n.id == h.name
                   for n in ast.walk(ast.Module(body=h.body,
                                                type_ignores=[])))


# ------------------------------------------------------------------ #
# entry points
# ------------------------------------------------------------------ #
def _waived_rules(source: str) -> Dict[int, Set[str]]:
    waivers: Dict[int, Set[str]] = {}
    for i, line in enumerate(source.splitlines(), start=1):
        m = _WAIVER_RE.search(line)
        if m:
            spec = m.group(1).strip()
            rules = (set(RULES) if spec == "all"
                     else {r.strip() for r in spec.split(",") if r.strip()})
            waivers[i] = rules
    return waivers


def lint_source(source: str, path: str = "<string>") -> List[Finding]:
    """Lint one module's source text; returns unwaived findings."""
    tree = ast.parse(source, filename=path)
    findings = _ModuleLinter(tree, path).run()
    waivers = _waived_rules(source)
    kept = [f for f in findings
            if f.rule not in waivers.get(f.line, set())]
    return sorted(kept, key=lambda f: (f.path, f.line, f.col, f.rule))


def lint_file(path: Path) -> List[Finding]:
    return lint_source(path.read_text(), str(path))


def lint_paths(paths: Sequence[Path]) -> List[Finding]:
    """Lint every .py file under the given files/directories."""
    findings: List[Finding] = []
    for p in paths:
        p = Path(p)
        files: Iterable[Path] = sorted(p.rglob("*.py")) if p.is_dir() else [p]
        for f in files:
            findings.extend(lint_file(f))
    return findings


def main(argv: Optional[Sequence[str]] = None) -> int:
    """The runner: lint `paths` (default src/repro_torch), print each
    finding; 1 while any remains, else 0."""
    import argparse
    import sys

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="The port's capture-safety lint. Waive an intended "
                    "line with `# pul-lint: disable=<rule>`.")
    ap.add_argument("paths", nargs="*", default=["src/repro_torch"],
                    help="files or directories (default: src/repro_torch)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    args = ap.parse_args(argv)
    if args.list_rules:
        for rule, desc in sorted(RULES.items()):
            print(f"{rule}  {desc}")
        return 0
    findings = lint_paths([Path(p) for p in args.paths])
    for f in findings:
        print(f.describe())
    if findings:
        print(f"\n{len(findings)} finding(s). Fix, or waive intended lines "
              "with `# pul-lint: disable=<rule>`.", file=sys.stderr)
        return 1
    print(f"pul-lint: clean ({', '.join(args.paths)})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
