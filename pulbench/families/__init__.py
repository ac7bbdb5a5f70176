"""Model families: one module a family, ``families/<family>.py``, found by
a configuration's ``reference`` key (the same name as its plain reference,
``reference/<family>.py``). A new family is these two modules and nothing
else of the shared code.

A family module holds everything that depends on the family's widths:

    arch(cfg)                  the widths of a configuration, as an object
    port_config(cfg)           the port's ``ModelConfig`` keyword arguments,
                               from the published keys alone; raises where
                               the config asks for what the port does not
                               compute
    layout(a)                  (path, shape, dtype) of every weight leaf, in
                               the port's tree layout, sorted by path
    active_params(a, head)     the frozen yardstick (``arith``): parameters
    decode_flops(a, contexts)  that multiply a token, a decode step's and a
    prefill_flops(a, prompt)   prefill's FLOPs, a decode step's bytes and one
    decode_bytes(a, contexts)  paged decode attention launch's bytes
    attention_kernel_bytes(a, contexts)
    TINY                       the published keys the CPU tests shrink, with
                               their tiny values
    PORT_FIELDS                which published key gives which
                               ``ModelConfig`` field

The only fields of an arch that shared code (``spec``, ``weights``,
``arith``, ``harness`` and the metric readers) reads are ``name``,
``family`` (the configuration's ``reference``), ``vocab``, ``vocab_rows``
(the port's padded table rows), ``layers``, ``init_std`` (the config's
``initializer_range``) and ``kv_row_bytes`` (bytes of one cached token
over all layers); everything else is the family's and its reference's.

Like ``spec``, nothing here imports torch or the port.
"""
from __future__ import annotations

import importlib
import math
import pkgutil
from types import ModuleType
from typing import Any, Dict, Iterable, List, Tuple

#: the port's row padding of the vocabulary (``ModelConfig.vocab_chunk``),
#: which the weight layout follows
VOCAB_CHUNK = 16384
#: a leaf's dtype in a layout, and its bytes an element
BF16, F32 = "bf16", "f32"
ITEMSIZE = {BF16: 2, F32: 4}


def known() -> List[str]:
    """The families found beside this module."""
    return sorted(m.name for m in pkgutil.iter_modules(__path__))


def family(name: str) -> ModuleType:
    """The module ``pulbench.families.<name>``; raises ``ValueError``
    naming the known families where there is none."""
    if name.isidentifier():
        try:
            return importlib.import_module(f"{__name__}.{name}")
        except ModuleNotFoundError as e:
            if e.name != f"{__name__}.{name}":
                raise
    raise ValueError(f"no model family {name!r}; known: {known()}")


def of(cfg: Dict[str, Any]) -> ModuleType:
    """The family of a configuration, by its ``reference`` key."""
    return family(cfg["reference"])


def layout_bytes(leaves: Iterable[Tuple[str, Tuple[int, ...], str]]) -> int:
    """Bytes of the leaves of a layout."""
    return sum(math.prod(s) * ITEMSIZE[dt] for _, s, dt in leaves)
