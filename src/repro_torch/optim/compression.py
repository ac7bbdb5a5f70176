"""Gradient compression (port of ``repro/optim/compression.py``): symmetric
per-tensor int8 quantization and its error-feedback form.

``quantize_int8`` maps x to round(x / scale) clipped to [-127, 127] with
scale = max|x| / 127 (1 for an all-zero tensor; round half to even, as
``jnp.round``); ``ef_quantize`` quantizes g + err and carries the residual
to the next step.

``ef_psum`` and ``ef_psum_tree`` are the collective forms: an int8 sum over
a group of ranks with error feedback, on each rank's local block (the
reference's ``shard_map`` body, ``jax.lax.pmax`` and ``psum`` over a named
axis). The axis is a dim name of the ambient mesh (``sharding.set_mesh``)
or a ``torch.distributed`` process group. The scale is agreed by an
all-reduce MAX of each rank's amax, so the int8 payloads sum exactly in
int32 (no overflow below 2^23 ranks); every other op is the reference's
fp32 op, so the sums and the new errors are its bits. As in the
reference, no trainer calls them.
"""
from __future__ import annotations

from typing import Tuple, Union

import torch

from repro_torch.checkpoint.checkpoint import flatten_state, unflatten_state
from repro_torch.models.module import flatten, unflatten
from repro_torch.runtime.sharding import current_mesh


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization. Returns (q, scale)."""
    x = x.float()
    amax = torch.max(torch.abs(x))
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def ef_quantize(g: torch.Tensor, err: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Error-feedback quantize: q(g + err); new_err = (g + err) - deq(q)."""
    corrected = g.float() + err
    q, scale = quantize_int8(corrected)
    return q, scale, corrected - dequantize_int8(q, scale)


def _group(axis):
    """The process group of `axis`: a dim name of the ambient mesh, or a
    group itself."""
    if not isinstance(axis, str):
        return axis
    mesh = current_mesh()
    if mesh is None:
        raise ValueError(f"axis {axis!r} names a mesh dim, but no mesh is "
                         "set (runtime.sharding.set_mesh)")
    return mesh.get_group(axis)


def ef_psum(g: torch.Tensor, err: torch.Tensor, axis: Union[str, object]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantized sum of `g` over the ranks of `axis` with error feedback.
    Every rank of the group calls it with its own block `g` and its own
    fp32 error state `err`; returns (the fp32 sum, the new error state)."""
    import torch.distributed as dist

    group = _group(axis)
    corrected = g.float() + err
    # agree on a shared scale so the sum is exact in the quantized domain
    amax = torch.max(torch.abs(corrected))
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(corrected / scale), -127, 127).to(torch.int8)
    new_err = corrected - q.float() * scale
    total = q.to(torch.int32)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    return total.float() * scale, new_err


def ef_psum_tree(grads, errs, axis):
    """:func:`ef_psum` over every leaf, in the JAX pytree order of
    ``checkpoint.flatten_state`` (every rank issues the collectives in the
    same order); returns (the summed grads, fp32, the new error state),
    each a tree shaped like `grads`."""
    out = [ef_psum(g, e, axis) for g, e in zip(
        flatten_state(grads), flatten_state(errs), strict=True)]
    return (unflatten_state(grads, [o[0] for o in out]),
            unflatten_state(grads, [o[1] for o in out]))


def init_error_state(params):
    """fp32 zeros shaped like every leaf of `params`."""
    return unflatten({k: torch.zeros(p.shape, dtype=torch.float32,
                                     device=p.device)
                      for k, p in flatten(params)})
