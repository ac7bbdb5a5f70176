"""Nothing of the benchmark loads JAX or the JAX package (top-level module
names compared whole: the port's name begins with the JAX package's), and
the plain references load nothing of the port either."""
import subprocess
import sys

from pulbench import spec

def _loaded(code):
    proc = subprocess.run([sys.executable, "-c", code + """
print(sorted({n.split(".", 1)[0] for n in sys.modules}))
"""], capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return set(eval(proc.stdout.strip().splitlines()[-1]))


def test_benchmark_loads_no_jax():
    code = f"""
import importlib, pkgutil, sys
sys.path[:0] = [{str(spec.ROOT)!r}, {str(spec.ROOT / 'src')!r}]
import pulbench
from pulbench import spec
for m in pkgutil.walk_packages(pulbench.__path__, "pulbench."):
    if ".tests" not in m.name:
        importlib.import_module(m.name)
for m in spec.benchmark()["per_layer"]:
    spec.metric_reader(m["name"])
from pulbench import trace
trace.mirror_tracer()
import repro_torch.serving.engine
"""
    top = _loaded(code)
    assert "pulbench" in top and "repro_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "repro"}


def test_references_load_nothing_of_the_port():
    code = f"""
import importlib, pkgutil, sys
sys.path[:0] = [{str(spec.ROOT)!r}]
import pulbench.reference
for m in pkgutil.walk_packages(pulbench.reference.__path__,
                               "pulbench.reference."):
    importlib.import_module(m.name)
"""
    top = _loaded(code)
    assert not top & {"jax", "jaxlib", "flax", "repro", "repro_torch"}
