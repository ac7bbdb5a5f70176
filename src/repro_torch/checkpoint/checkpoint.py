"""Asynchronous checkpointing (port of ``repro/checkpoint/checkpoint.py``):
the paper's unloading one level up. The state is snapshotted to host
memory in the step loop, then flushed to disk by a background writer while
training goes on; ``wait()`` joins the flush and re-raises its error.

Layout, the reference's:
  <dir>/step_<N>.tmp/           written first
      shard_0.npz               leaf_<i>: the i-th leaf, bf16 as uint16 bits
      manifest.json             step, tree description, shapes, dtypes
  <dir>/step_<N>/               atomic rename == commit marker

Leaves are numbered in the order JAX flattens a pytree: dict keys sorted,
tuple and list items in order. The port's trees are nested dicts (and
tuples of them), flattened the same way here, so ``leaf_i`` of a
checkpoint names the same tensor in both packages and either package
restores the other's checkpoints.

On a mesh (a default process group of more than one rank, or DTensor
leaves) the format stays the same: a DTensor leaf is made whole
(``full_tensor``, a collective that every rank calls in the same leaf
order) in the snapshot, and only rank 0 flushes and writes ``step_*/``;
the other ranks go on after the snapshot. ``save(block=True)`` ends in a
barrier, so every rank returns once the step is committed. ``restore``
loads each leaf whole and lays it out with the mesh and placements of the
``like`` leaf where that is a DTensor, or of ``shardings`` (a tree of
:class:`Layout`, the reference's ``NamedSharding`` tree), else puts it on
``device``: a checkpoint does not depend on the mesh that wrote it.
"""
from __future__ import annotations

import dataclasses
import json
import shutil
import threading
import time
from pathlib import Path
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.runtime.sharding import is_dtensor, whole

_DTYPES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
           torch.float16: "float16", torch.float64: "float64",
           torch.int32: "int32", torch.int64: "int64", torch.int8: "int8",
           torch.uint8: "uint8", torch.bool: "bool"}


@dataclasses.dataclass(frozen=True)
class Layout:
    """A restored leaf's place on a mesh: a DeviceMesh and one DTensor
    placement per mesh dim."""
    mesh: Any
    placements: Tuple[Any, ...]


def _rank_and_world() -> Tuple[int, int]:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _barrier() -> None:
    if _rank_and_world()[1] > 1:
        import torch.distributed as dist
        dist.barrier()


@dataclasses.dataclass(frozen=True)
class CheckpointConfig:
    directory: str
    keep: int = 3
    async_write: bool = True        # unload-style background flush


def flatten_state(tree) -> List[Any]:
    """The leaves of a tree of dicts, tuples and lists, in JAX's order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flatten_state(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in flatten_state(t)]
    return [tree]


def unflatten_state(like, leaves: List[Any]):
    """A tree shaped like `like` holding `leaves` in flatten_state's
    order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (tuple, list)):
            return type(t)(build(x) for x in t)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the prototype has")
    return out


def _snapshot(x) -> Tuple[np.ndarray, str]:
    """A host copy of one leaf that nothing else shares: (numpy array,
    dtype name); bf16 as its uint16 bit patterns (numpy has no bf16)."""
    if not isinstance(x, torch.Tensor):
        h = np.array(x)
        return h, str(h.dtype)
    # a DTensor is made whole first, a collective that every rank joins;
    # then a synchronous device -> host copy
    t = whole(x).detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), _DTYPES[t.dtype]


def _decode(h: np.ndarray, dtype_name: str) -> torch.Tensor:
    h = np.array(h)                 # a writable copy; keeps a 0-d leaf 0-d
    if dtype_name == "bfloat16":
        return torch.from_numpy(h.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(h)


class CheckpointManager:
    def __init__(self, cfg: CheckpointConfig):
        self.cfg = cfg
        self.dir = Path(cfg.directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._writer: Optional[threading.Thread] = None
        self._last_error: Optional[BaseException] = None

    # ------------------------------------------------------------------ #
    def save(self, step: int, state, *, block: bool = False):
        """Snapshot (device -> host, synchronous: when this returns, the
        caller may overwrite every tensor of `state`), then unload (host ->
        disk) in the background. Returns after the snapshot unless
        block=True. On a mesh every rank calls it; rank 0 writes."""
        self.wait()                                  # one in-flight flush
        snaps = [_snapshot(x) for x in flatten_state(state)]
        if _rank_and_world()[0] != 0:
            if block:
                _barrier()                           # rank 0 committed
            return
        host_leaves = [h for h, _ in snaps]
        manifest = {
            "step": step,
            "treedef": f"{len(host_leaves)} leaves, JAX pytree order",
            "shapes": [list(h.shape) for h in host_leaves],
            "dtypes": [d for _, d in snaps],
            "time": time.time(),
        }

        def _flush():
            try:
                tmp = self.dir / f"step_{step:08d}.tmp"
                final = self.dir / f"step_{step:08d}"
                if final.exists():
                    return                           # already committed
                if tmp.exists():
                    shutil.rmtree(tmp)
                tmp.mkdir(parents=True)
                np.savez(tmp / "shard_0.npz",
                         **{f"leaf_{i}": h for i, h in enumerate(host_leaves)})
                (tmp / "manifest.json").write_text(json.dumps(manifest))
                tmp.rename(final)                    # atomic commit
                self._gc()
            except BaseException as e:  # pul-lint: disable=PUL105 (re-raised by wait())
                self._last_error = e

        if self.cfg.async_write and not block:
            self._writer = threading.Thread(target=_flush, daemon=True)
            self._writer.start()
        else:
            _flush()
            self._raise_if_failed()
            if block:
                _barrier()

    def wait(self):
        """The PRELOAD_WAIT of unloading: join the in-flight flush."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        self._raise_if_failed()

    def _raise_if_failed(self):
        if self._last_error is not None:
            e, self._last_error = self._last_error, None
            raise RuntimeError(f"async checkpoint flush failed: {e}") from e

    # ------------------------------------------------------------------ #
    def _steps(self) -> List[int]:
        return sorted(int(p.name.split("_")[1]) for p in self.dir.iterdir()
                      if p.is_dir() and p.name.startswith("step_")
                      and not p.name.endswith(".tmp"))

    def latest_step(self) -> Optional[int]:
        s = self._steps()
        return s[-1] if s else None

    def _gc(self):
        steps = self._steps()
        for s in steps[: max(0, len(steps) - self.cfg.keep)]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # ------------------------------------------------------------------ #
    def restore(self, step: Optional[int] = None, *, like=None,
                device="cuda", shardings=None) -> Tuple[int, Any]:
        """Load a committed checkpoint (the latest unless `step`) into a
        tree shaped like `like`, every leaf in the dtype the manifest
        records: laid out by its `shardings` Layout (a tree shaped like
        `like`, None leaves allowed) if given, else like its `like` leaf
        if that is a DTensor (a collective: every rank of the mesh
        restores), else a tensor on `device` (the reference's
        ``shardings=None``)."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        if like is None:
            raise ValueError("restore needs `like` (a tree prototype)")
        dev = resolve_device(device)
        d = self.dir / f"step_{step:08d}"
        manifest = json.loads((d / "manifest.json").read_text())
        with np.load(d / "shard_0.npz") as data:
            leaves = [_decode(data[f"leaf_{i}"], manifest["dtypes"][i]).to(dev)
                      for i in range(len(data.files))]
        likes = flatten_state(like)
        layouts = (flatten_state(shardings) if shardings is not None
                   else [None] * len(likes))
        if not len(leaves) == len(likes) == len(layouts):
            raise ValueError(f"the checkpoint has {len(leaves)} leaves, "
                             f"`like` {len(likes)}, `shardings` "
                             f"{len(layouts)}")
        for i, (lk, lay) in enumerate(zip(likes, layouts)):
            if lay is None and is_dtensor(lk):
                lay = Layout(lk.device_mesh, tuple(lk.placements))
            if lay is not None:
                from torch.distributed.tensor import distribute_tensor
                leaves[i] = distribute_tensor(leaves[i], lay.mesh,
                                              list(lay.placements))
        return step, unflatten_state(like, leaves)
