"""Production meshes (port of ``repro/launch/mesh.py``).

Functions only: importing this module opens no process group and touches
no device. A mesh needs the default process group to exist (the dry-run
makes a ``fake`` one of 256 or 512 ranks; the card's 1x1 check a one-rank
``nccl`` one).

Axes:
  pod   - cross-pod data parallelism (2 pods in the multi-pod dry-run)
  data  - in-pod data parallelism / FSDP sharding
  model - tensor/expert parallelism
"""
from __future__ import annotations

import contextlib
import math
import os
import tempfile

from repro_torch.runtime.sharding import mesh_shape, set_mesh  # noqa: F401


def _mesh(device_type: str, shape, names):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """(16, 16) over ("data", "model"), or (2, 16, 16) over ("pod",
    "data", "model") with `multi_pod`."""
    if multi_pod:
        return _mesh(device_type, (2, 16, 16), ("pod", "data", "model"))
    return _mesh(device_type, (16, 16), ("data", "model"))


def make_debug_mesh(n_data: int = 2, n_model: int = 2, *,
                    device_type: str = "cuda"):
    """A small ("data", "model") mesh (needs n_data * n_model ranks)."""
    return _mesh(device_type, (n_data, n_model), ("data", "model"))


def mesh_chips(mesh) -> int:
    return math.prod(mesh_shape(mesh).values())


@contextlib.contextmanager
def one_rank_mesh(device_type: str = "cuda"):
    """A one-rank default process group (``nccl`` for "cuda", ``gloo``
    otherwise) that meets through a ``FileStore`` in a temporary directory,
    so no network is touched, and a (1, 1) ("data", "model") mesh on it,
    for the block."""
    import torch.distributed as dist

    if dist.is_initialized():
        raise RuntimeError("one_rank_mesh: a process group is already open")
    with tempfile.TemporaryDirectory() as d:
        store = dist.FileStore(os.path.join(d, "store"), 1)
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                                store=store, rank=0, world_size=1)
        try:
            yield make_debug_mesh(1, 1, device_type=device_type)
        finally:
            dist.destroy_process_group()
