"""Build and load the port's CUDA kernels (nvcc + ctypes, at first use).

Each source under ``src/repro_torch/csrc/`` exposes a plain C interface and
is compiled on its own into a shared library:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/lib<name>-<hash>.so \\
         src/repro_torch/csrc/<name>.cu

Sources may include the shared headers ``csrc/*.cuh``. The library name
carries a hash of the source, the headers and the flags, so a changed source
or header rebuilds and an unchanged one loads the existing build. The build
directory is ``build/kernels/`` at the root of the checkout (listed in
``.gitignore``). Nothing here runs at import time: the CPU tests import the
kernel modules without nvcc or a card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
#: per source: seconds nvcc took in this process (0.0 = loaded a prior build)
#: and what ptxas reported (registers, shared memory, spills)
BUILD_INFO: Dict[str, Dict[str, object]] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless this exact source is built."""
    src = CSRC_DIR / f"{name}.cu"
    text = src.read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha1(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    if out.exists():
        BUILD_INFO.setdefault(name, {"seconds": 0.0, "ptxas": ""})
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}\n"
                           f"{proc.stderr}")
    os.replace(tmp, out)        # atomic: a concurrent builder loads either
    BUILD_INFO[name] = {"seconds": time.perf_counter() - t0,
                        "ptxas": proc.stderr.strip()}
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built at first use)."""
    if name not in _LIBS:
        _LIBS[name] = ctypes.CDLL(str(build(name)))
    return _LIBS[name]
