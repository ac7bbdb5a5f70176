"""The port's capture-safety lint (``repro_torch.analysis.lint``) against
the reference's jit-safety lint (``repro.analysis.lint``).

PUL104, PUL105 and PUL106 are the reference's rules unchanged: on every
file of both packages (as written, and with every waiver comment taken
out) and on every snippet of ``tests/test_analysis_lint.py`` the two lints
report them at the same (rule, path, line). PUL101, PUL102 and PUL107 are
translated to the port's compiled context (the functions a CUDA graph
captures) and each has a firing and a clean case here; PUL103 is dropped.
The port's tree lints clean under its own runner and under the
reference's rules.
"""
from __future__ import annotations

import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro.analysis import lint as ref_lint
from repro_torch.analysis import lint as L

ROOT = Path(__file__).resolve().parent.parent
SHARED = {"PUL104", "PUL105", "PUL106"}


def _shared(findings):
    return [(f.rule, f.path, f.line) for f in findings if f.rule in SHARED]


def _sources():
    return sorted((ROOT / "src" / "repro").rglob("*.py")) + sorted(
        (ROOT / "src" / "repro_torch").rglob("*.py"))


@pytest.mark.parametrize("waivers", ["kept", "stripped"])
def test_shared_rules_equal_reference_on_both_packages(waivers):
    total = 0
    for path in _sources():
        src = path.read_text()
        if waivers == "stripped":
            src = src.replace("pul-lint:", "pul-lint-off:")
        want = _shared(ref_lint.lint_source(src, str(path)))
        assert _shared(L.lint_source(src, str(path))) == want, path
        total += len(want)
    if waivers == "stripped":
        assert total >= 2          # both packages' waived PUL105 handlers


def _snippets():
    """The source strings that tests/test_analysis_lint.py lints."""
    tree = ast.parse((ROOT / "tests" / "test_analysis_lint.py").read_text())
    out = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id in ("_lint", "_rules") and node.args
                and isinstance(node.args[0], ast.Constant)):
            out.append(textwrap.dedent(node.args[0].value))
    return out


def test_shared_rules_equal_reference_on_its_snippets():
    snippets = _snippets()
    assert len(snippets) == 39
    fired = 0
    for i, code in enumerate(snippets):
        want = _shared(ref_lint.lint_source(code, f"snippet{i}.py"))
        assert _shared(L.lint_source(code, f"snippet{i}.py")) == want, code
        fired += bool(want)
    assert fired >= 8


def _rules(code):
    return [f.rule for f in L.lint_source(textwrap.dedent(code), "fx.py")]


def test_rule_catalog_drops_pul103():
    assert set(L.RULES) == {"PUL101", "PUL102", "PUL104", "PUL105",
                            "PUL106", "PUL107"}
    assert _rules("""
        from jax.experimental import pallas as pl

        def build(n: "jax.Array"):
            return pl.BlockSpec((n, 128), lambda i: (i, 0))
    """) == []


@pytest.mark.parametrize("code,want", [
    # PUL101: a branch on a device value inside the captured step
    ("""
     def step(x):
         if x.sum() > 0:
             return x
         return -x

     graph = CapturedStep(step, inputs=[], planes={}, what="t")
     """, ["PUL101"]),
    # shapes, addresses and host-annotated values are static
    ("""
     def step(x, n: int):
         if x.shape[0] > 8 and x.data_ptr() % 16 == 0 and n > 4:
             return x[:8]
         if x is None or x.dim() == 1:
             return x
         return x

     graph = CapturedStep(step, inputs=[], planes={}, what="t")
     """, []),
    # outside the captured context only a torch.Tensor annotation traces
    ("""
     import torch

     def host(x: torch.Tensor, y):
         while x.any():
             x = x - 1
         if y.any():
             pass
     """, ["PUL101"]),
    # PUL102: syncs in a function called inside a StepGuard block
    ("""
     import numpy as np

     def step(x):
         a = x.item()
         b = float(x[0])
         c = np.asarray(x)
         return x.cpu(), a, b, c

     def check(x):
         with StepGuard("cpu", [x]):
             step(x)
     """, ["PUL102"] * 4),
    # the same syncs outside the captured context are the host's business
    ("""
     import numpy as np

     def report(x):
         return float(np.asarray(x).mean()), x.item(), x.tolist()
     """, []),
    # a method reference and a torch.cuda.graph block are captured too
    ("""
     import torch

     class Engine:
         def _device_step(self):
             out = torch.zeros(4)
             return out.tolist()

         def _run(self, g, fn):
             with torch.cuda.graph(g):
                 self.out = fn()

         def capture(self):
             return CapturedStep(self._device_step, inputs=[], planes={},
                                 what="t")

     def fn(x):
         return int(x)
     """, ["PUL102", "PUL102"]),
    # PUL107: an out-of-place indexed update of a captured step's input
    ("""
     def commit(planes, rows, idx):
         return planes.index_put((idx,), rows)

     graph = CapturedStep(commit, inputs=[], planes={}, what="t")
     """, ["PUL107"]),
    # the in-place form, or a value built inside the step, is clean
    ("""
     import functools
     import torch

     def commit(planes, rows, idx):
         planes.index_put_((idx,), rows)
         buf = torch.zeros(4)
         return buf.scatter(0, idx, rows)

     bound = functools.partial(commit)
     graph = CapturedStep(bound, inputs=[], planes={}, what="t")
     """, []),
    # a lambda handed to the capture wrapper is linted as captured
    ("""
     graph = CapturedStep(lambda x: x.item(), inputs=[], planes={}, what="t")
     """, ["PUL102"]),
    # waivers work as in the reference
    ("""
     def commit(planes, idx):
         return planes.index_fill(0, idx, 0.0)  # pul-lint: disable=PUL107

     graph = CapturedStep(commit, inputs=[], planes={}, what="t")
     """, []),
])
def test_translated_rules(code, want):
    assert _rules(code) == want


def test_engine_captured_step_is_in_the_captured_context():
    """serving/engine.py hands CapturedStep `self._device_step`: the lint
    checks that body under the captured rules."""
    path = ROOT / "src" / "repro_torch" / "serving" / "engine.py"
    linter = L._ModuleLinter(ast.parse(path.read_text()), str(path))
    assert "_device_step" in linter.capture_names


def _run(*args, cwd=ROOT):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.analysis.lint",
                           *args], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=120)


def test_runner_is_clean_on_the_port(tmp_path):
    proc = _run()
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "clean (src/repro_torch)" in proc.stdout
    bad = tmp_path / "bad.py"
    bad.write_text("def admit(reqs=[]):\n    return reqs\n")
    proc = _run(str(bad))
    assert proc.returncode == 1
    assert f"{bad}:1:15: PUL104" in proc.stdout
    proc = _run("--list-rules")
    assert proc.returncode == 0 and "PUL103" not in proc.stdout


def test_reference_rules_are_clean_on_the_port():
    """The reference's lint over the port: the flush handler's PUL105
    waiver is carried over (wait() re-raises)."""
    findings = ref_lint.lint_paths([ROOT / "src" / "repro_torch"])
    assert findings == [], "\n".join(f.describe() for f in findings)
