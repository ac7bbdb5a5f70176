"""The port stands alone: repro_torch imports neither JAX nor the reference.

Every module of ``src/repro_torch`` is imported in a fresh interpreter with
``sys.modules["jax"] = None`` (any ``import jax`` then fails), and no source
file of the port, nor ``chip_smoke.py``, names jax or the ``repro`` package
in an import statement.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
_IMPORT = re.compile(
    r"^\s*(?:from\s+(jax|repro)(?:\.|\s)|import\s+(jax|repro)(?:\.|\s|,|$))",
    re.MULTILINE)

_PROBE = """
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
assert not any(k == "jax" or k.startswith(("jax.", "jaxlib"))
               for k, v in sys.modules.items() if v is not None)
print(len(names))
"""


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_every_port_module_imports_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _PROBE], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 82     # every module, not a stub


@pytest.mark.parametrize("module", [
    "repro_torch.configs.deepseek_v2_236b", "repro_torch.models.mla",
    "repro_torch.models.moe", "repro_torch.kernels.pul_attention"])
def test_mla_slice_module_imports_with_jax_blocked(module):
    """The deepseek slice's modules on their own, jax and repro blocked."""
    probe = ("import importlib, sys\n"
             "sys.modules['jax'] = None\nsys.modules['repro'] = None\n"
             f"importlib.import_module({module!r})\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", probe], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("module", [
    "repro_torch.kernels.pul_gather", "repro_torch.serving.engine",
    "repro_torch.launch.serve"])
def test_assembly_slice_module_imports_with_jax_blocked(module):
    """The assembly slice's modules (the gather K5, the assembly path and
    the dense engine, the --dense launcher) on their own, jax and repro
    blocked."""
    test_mla_slice_module_imports_with_jax_blocked(module)


@pytest.mark.parametrize("module", [
    "repro_torch.kernels.pul_sum", "repro_torch.kernels.pul_filter",
    "repro_torch.kernels.pul_matmul", "repro_torch.kernels.ref",
    "repro_torch.kernels.ops", "repro_torch.benchmarks.paper_experiments",
    "repro_torch.benchmarks.run", "repro_torch.examples.quickstart",
    "repro_torch.examples.pul_microbench"])
def test_microbench_slice_module_imports_with_jax_blocked(module):
    """The microbenchmark slice's modules (K8-K10, the ops, the paper's
    experiments and examples) on their own, jax and repro blocked; importing
    a benchmark or an example runs nothing."""
    test_mla_slice_module_imports_with_jax_blocked(module)


@pytest.mark.parametrize("module", [
    "repro_torch.kernels._runtime", "repro_torch.kernels.pul_decode",
    "repro_torch.kernels.pul_attention", "repro_torch.kernels.ref",
    "repro_torch.kernels.ops", "repro_torch.kernels"])
def test_dense_attention_slice_module_imports_with_jax_blocked(module):
    """The dense attention slice's modules (the shared wrapper runtime, K6,
    K7, the oracles and ops.attention_op) on their own, jax and repro
    blocked."""
    test_mla_slice_module_imports_with_jax_blocked(module)


@pytest.mark.parametrize("module", [
    "repro_torch.analysis", "repro_torch.analysis.sanitizer",
    "repro_torch.analysis.plan_verifier", "repro_torch.serving",
    "repro_torch.benchmarks.common",
    "repro_torch.benchmarks.flops", "repro_torch.benchmarks.roofline",
    "repro_torch.benchmarks.serving_slo", "repro_torch.benchmarks.paged_decode",
    "repro_torch.benchmarks.kv_page_dma", "repro_torch.examples.serve_lm"])
def test_serving_bench_slice_module_imports_with_jax_blocked(module):
    """The serving benchmarks' slice (the lifecycle sanitizer and
    diff_fifo_occupancy, the engine's shadow_check and percentile, the
    serving scripts and the serve example) on its own, jax and repro
    blocked; importing a script runs nothing."""
    test_mla_slice_module_imports_with_jax_blocked(module)


TRAINING_SLICE = (
    "repro_torch.optim", "repro_torch.optim.optimizer",
    "repro_torch.optim.compression", "repro_torch.data",
    "repro_torch.data.pipeline", "repro_torch.checkpoint",
    "repro_torch.checkpoint.checkpoint", "repro_torch.runtime",
    "repro_torch.runtime.fault", "repro_torch.launch.steps",
    "repro_torch.launch.train", "repro_torch.examples.train_lm")


def test_training_slice_modules_import_with_jax_blocked():
    """The training slice's modules (AdamW and the int8 compression, the
    token pipeline, the checkpoints, the fault runtime, the steps, the
    trainer and its example), each imported first in one interpreter with
    jax and repro blocked; importing the trainer or the example runs
    nothing (no output)."""
    probe = ("import importlib, sys\n"
             "sys.modules['jax'] = None\nsys.modules['repro'] = None\n"
             f"for name in {TRAINING_SLICE!r}:\n"
             "    importlib.import_module(name)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", probe], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout == ""


@pytest.mark.parametrize("module", [
    "repro_torch.analysis.lint", "repro_torch.optim.compression",
    "repro_torch.launch.train", "repro_torch.checkpoint.checkpoint"])
def test_mesh_training_slice_module_imports_with_jax_blocked(module):
    """The mesh-training slice's modules (the capture-safety lint and its
    runner, ef_psum, the trainer's --mesh, the checkpoints on a mesh) on
    their own, jax and repro blocked; importing the lint runs nothing."""
    test_mla_slice_module_imports_with_jax_blocked(module)


def test_no_port_source_imports_jax_or_the_reference():
    offenders = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
                 for f in _port_sources()
                 for m in _IMPORT.finditer(f.read_text())]
    assert offenders == [], offenders


def test_import_pattern_catches_what_it_must():
    for bad in ("import jax", "import jax.numpy as jnp", "from jax import lax",
                "from repro.core import PULConfig", "import repro.serving",
                "    from repro.models import zoo"):
        assert _IMPORT.search(bad), bad
    for fine in ("import repro_torch", "from repro_torch.core import x",
                 "# the reference's repro.core module"):
        assert not _IMPORT.search(fine), fine


def test_chip_smoke_fails_without_cuda():
    """Without a card the smoke script exits non-zero and prints no result."""
    if __import__("torch").cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
