"""PyTorch/CUDA port of the PUL serving stack (reference: ``repro``).

The package mirrors the reference's layout, one file per reference file, and
imports neither JAX nor anything of ``repro``. Entry points take ``device=``
and default to ``"cuda"``; :func:`resolve_device` raises when CUDA is asked
for and absent, so nothing silently runs on the CPU. The tests pass
``device="cpu"``, where every kernel wrapper takes its plain PyTorch version.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The torch device for an entry point; raises if CUDA is unavailable."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels")
    return dev
