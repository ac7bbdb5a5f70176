"""Logical-axis sharding rules with divisibility-aware fallback (port of
``repro/runtime/sharding.py``).

Every tensor carries *logical* axis names ("embed", "heads", "ff", "batch",
...). This module resolves them to mesh axes on the production mesh
``(pod, data, model)``:

  * weights are 2D-sharded: FSDP (ZeRO-3) over ``("pod", "data")`` on their
    d_model-sized dim, tensor-parallel over ``"model"`` on heads/ff/vocab/
    experts;
  * activations are batch-sharded over ``("pod", "data")``; KV caches
    additionally shard the sequence dim over ``"data"`` or ``"model"``;
  * each rule is a *priority list*: the resolver picks the first candidate
    whose device count divides the dim and whose mesh axes are not already
    used by an earlier dim of the same tensor, else replicates.

A spec is a plain tuple with one entry per leading tensor dim (``None``, a
mesh axis name, or a tuple of names), trailing ``None``s dropped: it equals
the reference's ``PartitionSpec`` turned into a tuple. :func:`placements`
turns it into one ``Shard``/``Replicate`` per dim of a ``DeviceMesh``. A
mesh here is a ``DeviceMesh`` with dim names, or any object whose ``shape``
is a {axis name: size} dict (the stub meshes of the tests).

:func:`constrain` is the port's ``with_sharding_constraint``: inside
:func:`set_mesh` it redistributes a tensor to its resolved placements,
outside it returns its argument untouched.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, Iterator, Optional, Sequence, Tuple, Union

import torch

Axis = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Axis, ...]

# priority list per logical name; None means "replicate" and always succeeds
DEFAULT_RULES: Dict[str, Sequence[Axis]] = {
    # ---- weight dims ----
    "embed": (("pod", "data"), "data", None),   # FSDP / ZeRO-3 shard dim
    "ff": ("model", None),                  # tensor parallel
    "vocab": ("model", None),
    "heads": ("model", None),
    "kv_heads": ("model", None),
    "experts": ("model", None),             # expert parallel
    "dinner": ("model", None),              # mamba inner channels
    "head_dim": (None,),
    "state": (None,),                       # SSM state dim
    "conv": (None,),
    "lora": (None,),
    "kv_rank": (None,),                     # MLA compressed dims stay local
    "q_rank": (None,),
    "norm": (None,),
    # ---- activation dims ----
    "batch": (("pod", "data"), "data", None),
    "seq": (None,),
    "act_embed": (None,),
    "act_heads": ("model", None),
    "act_kv_heads": ("model", None),
    "act_ff": ("model", None),
    # KV cache: the sequence shards over whichever axis the batch/head dims
    # left free (the model axis on GQA models with fewer kv heads than it)
    "cache_seq": ("data", "model", None),
    "seq_model": ("model", None),           # remat-carry sequence sharding
    "cache_batch": (("pod", "data"), "data", None),
    "expert_cap": (None,),
    "codebooks": (None,),
}


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    rules: Dict[str, Sequence[Axis]] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_RULES)
    )

    def with_overrides(self, **over: Sequence[Axis]) -> "ShardingRules":
        r = dict(self.rules)
        r.update(over)
        return ShardingRules(r)


def mesh_shape(mesh) -> Dict[str, int]:
    """{axis name: size} of a DeviceMesh or of a stub mesh."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def _axis_names(axis: Axis) -> Tuple[str, ...]:
    if axis is None:
        return ()
    if isinstance(axis, str):
        return (axis,)
    return tuple(axis)


def logical_to_spec(
    logical: Sequence[Optional[str]],
    dims: Sequence[int],
    mesh,
    rules: ShardingRules = ShardingRules(),
) -> Spec:
    """Resolve one tensor's logical axes to a spec.

    Left-to-right; a mesh axis is used at most once per tensor; a candidate
    is accepted only if its total device count divides the dim size; a
    candidate naming an axis absent from the mesh is skipped.
    """
    if len(logical) != len(dims):
        raise ValueError(f"logical {logical} does not match rank of shape {dims}")
    shape = mesh_shape(mesh)
    used: set = set()
    out = []
    for name, dim in zip(logical, dims):
        picked: Axis = None
        for cand in rules.rules.get(name, (None,)) if name is not None else (None,):
            names = _axis_names(cand)
            if any(n not in shape for n in names):
                continue  # axis absent on this mesh (e.g. single-pod)
            if any(n in used for n in names):
                continue
            if dim % math.prod(shape[n] for n in names) != 0:
                continue
            picked = cand
            break
        used.update(_axis_names(picked))
        out.append(picked)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def placements(spec: Spec, mesh):
    """One ``Shard(i)`` or ``Replicate()`` per dim of `mesh` (a DeviceMesh
    with dim names). A tuple entry such as ("pod", "data") shards tensor
    dim i over both mesh dims, the first named the major one, as JAX lays
    it out; DTensor splits a dim sharded over several mesh dims in mesh-dim
    order, so the names must come in that order. Every spec the resolver
    gives divides its dims, so no shard is uneven. A mesh dim of one device
    holds the whole tensor whichever placement it takes: it is given
    ``Replicate()``, since DTensor would otherwise track a split that
    splits nothing, and some of its view rules fail on such a split."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for i, entry in enumerate(spec):
        axes = _axis_names(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} is not in the mesh's "
                             f"dim order {tuple(names)}")
        for j in idx:
            if mesh_shape(mesh)[names[j]] > 1:
                out[j] = Shard(i)
    return out


def local_shape(shape: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    """The shard shape that one device holds of a tensor laid out by spec."""
    sizes = mesh_shape(mesh)
    out = list(shape)
    for i, entry in enumerate(spec):
        out[i] //= math.prod(sizes[a] for a in _axis_names(entry))
    return tuple(out)


def _map2(fn, a, b):
    """fn over the leaves of two nested dicts of one structure (`a`'s
    leaves: logical-axis tuples)."""
    if isinstance(a, dict):
        return {k: _map2(fn, a[k], b[k]) for k in a}
    return fn(a, b)


def _shape_of(x) -> Tuple[int, ...]:
    return tuple(x.shape) if hasattr(x, "shape") else tuple(x[0])


def spec_tree(logical_tree, shape_tree, mesh,
              rules: ShardingRules = ShardingRules()):
    """Nested dict of logical-axis tuples + a tree of the same structure
    whose leaves have a ``shape`` (tensors, Params) or are (shape, dtype)
    pairs -> a tree of specs."""
    return _map2(lambda logical, s: logical_to_spec(logical, _shape_of(s),
                                                    mesh, rules),
                 logical_tree, shape_tree)


def sharding_tree(logical_tree, shape_tree, mesh,
                  rules: ShardingRules = ShardingRules()):
    """Like :func:`spec_tree`, each leaf a list of DTensor placements."""
    return _map2(lambda logical, s: placements(
        logical_to_spec(logical, _shape_of(s), mesh, rules), mesh),
        logical_tree, shape_tree)


# --------------------------------------------------------------------------
# ambient mesh
# --------------------------------------------------------------------------
#: the mesh `constrain` resolves against; a module-level slot, not a
#: context variable, so the autograd engine's device threads (which run a
#: remat checkpoint's recomputation) see it too
_MESH = [None]


def _implicit_replication_mode():
    """A dispatch mode under which an op that mixes DTensors with plain
    tensors treats the plain ones as replicated (``implicit_replication``)
    in whichever thread runs it. DTensor keeps that switch per thread; a
    dispatch mode travels with the autograd engine into its device threads,
    where a remat checkpoint recomputes its forward."""
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode

    get = torch._C._get_dtensor_allow_implicit_replication
    put = torch._C._set_dtensor_allow_implicit_replication

    class ImplicitReplication(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not any(issubclass(t, DTensor) for t in types):
                return func(*args, **(kwargs or {}))
            prev = get()
            put(True)
            try:
                return func(*args, **(kwargs or {}))
            finally:
                put(prev)

    return ImplicitReplication()


@contextlib.contextmanager
def set_mesh(mesh) -> Iterator[None]:
    """Make `mesh` (a DeviceMesh with dim names) the ambient mesh of
    :func:`constrain` for the block, the previous one back after. Inside,
    tensors the model makes itself (positions, rope tables, masks), whole
    on every rank, meet DTensors as replicated ones."""
    prev = _MESH[0]
    _MESH[0] = mesh
    try:
        if mesh is None:
            yield
        else:
            with _implicit_replication_mode():
                yield
    finally:
        _MESH[0] = prev


def current_mesh():
    return _MESH[0]


def constrain(x, logical: Sequence[Optional[str]],
              rules: ShardingRules = ShardingRules()):
    """The reference's ``with_sharding_constraint`` via logical names.

    Outside :func:`set_mesh` it returns `x` itself before any work. Inside,
a plain tensor (one the model made, whole on every rank) becomes a
    replicated DTensor, and the DTensor is redistributed to the placements
    that `logical` resolves to on the ambient mesh (differentiable: the
    backward brings the gradient to the same placements, then back to the
    input's)."""
    mesh = _MESH[0]
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor, Replicate

    spec = logical_to_spec(logical, x.shape, mesh, rules)
    target = placements(spec, mesh)
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    # redistributed even where the layout already matches: the backward
    # then brings the gradient to this layout too, as JAX constrains the
    # cotangent of a sharding constraint
    return x.redistribute(mesh, target)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def whole(x):
    """A DTensor made whole on every rank (a collective; differentiable, the
    gradient going back to its placements), a plain tensor as it is."""
    return x.full_tensor() if is_dtensor(x) else x


def distribute_tree(tree, placements_tree, mesh):
    """Every leaf of a nested dict laid out on `mesh` by the placements
    at the same path of `placements_tree` (``distribute_tensor``: every
    rank calls it, in the same leaf order, with the same whole tensor)."""
    from torch.distributed.tensor import distribute_tensor
    if isinstance(tree, dict):
        return {k: distribute_tree(tree[k], placements_tree[k], mesh)
                for k in tree}
    return distribute_tensor(tree, mesh, placements_tree)


def split_dims(x) -> set:
    """The dims of `x` that a DTensor splits over some mesh dim of more
    than one device (none for a plain tensor, or on a 1x1 mesh)."""
    if not is_dtensor(x):
        return set()
    mesh = x.device_mesh
    return {p.dim for i, p in enumerate(x.placements)
            if p.is_shard() and mesh.size(i) > 1}


__all__ = ["Axis", "Spec", "DEFAULT_RULES", "ShardingRules", "mesh_shape",
           "logical_to_spec", "placements", "local_shape", "spec_tree",
           "sharding_tree", "set_mesh", "current_mesh", "constrain",
           "is_dtensor", "whole", "distribute_tree", "split_dims"]
