"""The paged decode step as one captured CUDA graph: the port's counterpart
of the reference's ``jax.jit`` of the step (``repro/serving/engine.py``,
``_paged_decode`` / ``_sweep_decode``).

A step is capturable when it reads the host nothing back, makes no tensor
from host data, copies nothing between devices and reads only tensors whose
addresses stay fixed: the weights, the page planes and one static input
buffer. :class:`StepGuard` watches every aten op of a step and raises on
any other; the tests run it on the CPU, and :class:`CapturedStep` runs it
over the warm-up and the capture on the card, so that a step that cannot be
captured fails naming its op.

:class:`CapturedStep` warms a step function up on a side stream (library
loads, the kernels' one-time shared-memory opt-ins, cuBLAS handles and the
allocator are set up outside the capture), captures it once with
``torch.cuda.graph`` and replays it. The kernel wrappers count their
launches in Python (``kernels._runtime.LAUNCHES``), which a replay skips:
the counts a capture made are recorded, taken back, and added on every
replay, so the counts stay one per launch the device runs. The planes are
allocated once and updated in place by the step (the counterpart of the
reference's donation); a replay checks their addresses first and raises if
a plane was reallocated behind the graph's back. There is no fallback to
the eager step: a capture or replay that fails raises.

:class:`StepTimer` times a step on the card with two CUDA events recorded
around it and maps them onto a host clock (the engine's tracer's) through
an anchor event; a :class:`CapturedStep` given one records them around
each replay. The engine makes one only when its tracer records.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels._runtime import LAUNCHES

#: aten ops that read a device value back to the host (``.item()``,
#: ``nonzero``, ``masked_select``, ``unique``, a tensor's truth value) or
#: make a tensor from host data (``torch.tensor``, ``torch.as_tensor``)
HOST_OPS = frozenset({
    "_local_scalar_dense", "nonzero", "nonzero_static", "masked_select",
    "_unique", "_unique2", "unique_dim", "unique_consecutive",
    "unique_dim_consecutive", "is_nonzero", "equal", "lift_fresh",
    "lift_fresh_copy"})
#: aten ops that copy a tensor, possibly between devices
_COPIES = frozenset({"_to_copy", "copy_", "_copy_from",
                     "_copy_from_and_resize"})
#: aten ops that index, where a boolean index is a hidden ``nonzero``
_INDEXING = frozenset({"index", "index_put", "index_put_",
                       "_index_put_impl_"})


class StepNotCapturable(RuntimeError):
    """An op of a decode step that a CUDA graph cannot hold."""


def _tensors(xs) -> Iterable[torch.Tensor]:
    for x in xs:
        if isinstance(x, torch.Tensor):
            yield x
        elif isinstance(x, (list, tuple)):
            yield from _tensors(x)


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


class StepGuard(TorchDispatchMode):
    """Watches the aten ops of one decode step on `device`.

    Raises :class:`StepNotCapturable` on an op of :data:`HOST_OPS`, on a
    boolean index, on a copy between devices, and on a tensor that the step
    reads but neither made itself nor was given in `inputs` (by storage:
    the weights, the planes and the static input buffer), which would be a
    fresh host tensor or a buffer whose address the graph cannot keep.
    ``ops`` lists the ops in order, so two steps can be checked for the
    same op sequence whatever their lengths."""

    def __init__(self, device, inputs: Iterable[torch.Tensor]):
        super().__init__()
        self.device = torch.device(device).type
        self.ops: List[str] = []
        self._known = {_storage(t) for t in inputs}

    def _refuse(self, func, why: str):
        raise StepNotCapturable(f"{func} (op {len(self.ops)} of the step) "
                                f"{why}")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func._schema.name.split("::")[-1]
        self.ops.append(str(func))
        if name in HOST_OPS:
            self._refuse(func, "reads the device back to the host or makes "
                         "a tensor from host data")
        ins = list(_tensors((*args, *kwargs.values())))
        if name in _INDEXING and any(t.dtype == torch.bool
                                     for t in _tensors(args[1:2])):
            self._refuse(func, "indexes by a boolean mask (a hidden nonzero)")
        if name in _COPIES:
            devs = {t.device for t in ins}
            if kwargs.get("device") is not None:
                devs.add(torch.device(kwargs["device"]))
            if len(devs) > 1:
                self._refuse(func, "copies between devices "
                             f"{sorted(map(str, devs))}")
        for t in ins:
            if t.device.type != self.device:
                self._refuse(func, f"reads a tensor on {t.device}")
            if t.numel() and _storage(t) not in self._known:
                self._refuse(func, f"reads a {tuple(t.shape)} tensor made "
                             "outside the step")
        out = func(*args, **kwargs)
        for t in _tensors(out if isinstance(out, (list, tuple)) else (out,)):
            if t.numel():
                self._known.add(_storage(t))
        return out


#: seconds between two anchors of a :class:`StepTimer`
REANCHOR_S = 1.0


class StepTimer:
    """A decode step's device time from two reusable CUDA events recorded
    on the current stream around it (:meth:`begin`, :meth:`end`), placed on
    the host clock `clock` (microseconds, the tracer's ``now_us``).

    The anchor is an event recorded on an idle card, read between two
    readings of `clock`: an event lies at the anchor's host time plus the
    card's time since the anchor. The card's clock drifts from the host's,
    so :meth:`reanchor_if_due` sets the anchor again every
    :data:`REANCHOR_S` and returns the drift the old anchor had gathered."""

    def __init__(self, clock: Callable[[], float], device):
        self._clock = clock
        self._device = torch.device(device)
        self._start = torch.cuda.Event(enable_timing=True)
        self._end = torch.cuda.Event(enable_timing=True)
        self._anchors = [torch.cuda.Event(enable_timing=True),
                         torch.cuda.Event(enable_timing=True)]
        self.anchor_us = self._mark(self._anchors[0])

    def _mark(self, event) -> float:
        """Record `event` on the idle card; its time on the host clock (the
        middle of the two readings around the record and its wait)."""
        torch.cuda.synchronize(self._device)
        before = self._clock()
        event.record()
        event.synchronize()
        return (before + self._clock()) / 2

    def begin(self) -> None:
        self._start.record()

    def end(self) -> None:
        self._end.record()

    def span_us(self) -> Tuple[float, float]:
        """The last step's start on the host clock and its device time, in
        microseconds; call once its end event has completed."""
        anchor = self._anchors[0]
        return (self.anchor_us + anchor.elapsed_time(self._start) * 1e3,
                self._start.elapsed_time(self._end) * 1e3)

    def reanchor_if_due(self) -> Optional[float]:
        """Past :data:`REANCHOR_S` since the anchor, a new anchor; returns
        where it lies on the host clock less where the old anchor put it
        (µs), else None."""
        if self._clock() - self.anchor_us < REANCHOR_S * 1e6:
            return None
        old, new = self._anchors
        now = self._mark(new)
        drift = now - (self.anchor_us + old.elapsed_time(new) * 1e3)
        self._anchors = [new, old]
        self.anchor_us = now
        return drift


class CapturedStep:
    """`fn` (no arguments; it reads only `inputs`, whose addresses stay
    fixed) captured once as a CUDA graph and replayed.

    `planes` are the tensors the step updates in place; :meth:`replay`
    checks that the planes it is given are still at the captured addresses.
    `what` names the step in errors. With a `timer`, each replay records
    its events around ``graph.replay()``."""

    def __init__(self, fn: Callable, *, inputs: List[torch.Tensor],
                 planes: Dict[str, torch.Tensor], what: str,
                 timer: Optional[StepTimer] = None):
        self.what = what
        self.timer = timer
        self._ptrs = {k: p.data_ptr() for k, p in planes.items()}
        device = next(iter(planes.values())).device
        counts = dict(LAUNCHES)
        self.graph = torch.cuda.CUDAGraph()
        stream = torch.cuda.Stream(device)
        guard = StepGuard(device, inputs)
        try:
            stream.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(stream), guard:
                fn()                    # the warm-up
            torch.cuda.current_stream(device).wait_stream(stream)
            LAUNCHES.update(counts)     # the warm-up's launches: no step's
            with torch.cuda.graph(self.graph, stream=stream), guard:
                self.out = fn()
        except StepNotCapturable:
            raise
        except RuntimeError as e:       # a CUDA error or a refused launch
            last = guard.ops[-1] if guard.ops else "its first op"
            raise RuntimeError(f"capturing the {what} decode step failed "
                               f"after {last}: {e}") from e
        #: launches of one replay, by kernel (counted once, at capture)
        self.launches = {k: n - counts[k] for k, n in LAUNCHES.items()
                         if n != counts[k]}
        LAUNCHES.update(counts)

    def replay(self, planes: Dict[str, torch.Tensor]):
        """Run the captured step on the current stream over `planes` (which
        must be the captured ones); returns its static outputs, overwritten
        by the next replay."""
        moved = sorted(k for k in {*planes, *self._ptrs}
                       if k not in planes or k not in self._ptrs
                       or planes[k].data_ptr() != self._ptrs[k])
        if moved:
            raise RuntimeError(f"the {self.what} decode step was captured "
                               f"over other planes: {moved} were "
                               "reallocated since")
        try:
            if self.timer is None:
                self.graph.replay()
            else:
                self.timer.begin()
                self.graph.replay()
                self.timer.end()
        except RuntimeError as e:
            raise RuntimeError(f"replay of the captured {self.what} decode "
                               f"step failed: {e}") from e
        for k, n in self.launches.items():
            LAUNCHES[k] += n
        return self.out
