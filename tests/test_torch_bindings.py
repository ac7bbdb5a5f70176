"""The port's Python wrappers and its CUDA sources agree on what they share.

The kernels build only on a machine with nvcc and a card, so these checks
read the sources: every C entry point takes as many arguments as its ctypes
signature (``_runtime.SIGNATURES``) passes, and the constants a wrapper
plans with are the ones the source's kernel is built with. On the card the
entry points check the plan itself (K6 refuses a chunk that is not its own).
"""
import importlib
import re

import pytest

from repro_torch.kernels import SOURCES
from repro_torch.kernels._build import CSRC_DIR
from repro_torch.kernels._runtime import SIGNATURES

# the modules (the package exports the wrappers under the modules' names)
pul_decode = importlib.import_module("repro_torch.kernels.pul_decode")
pul_filter = importlib.import_module("repro_torch.kernels.pul_filter")

_ENTRY = re.compile(r"^int\s+(\w+)\(([^)]*)\)\s*\{", re.MULTILINE)


def _entry_points(source: str):
    """{name: number of parameters} of the extern "C" functions."""
    text = (CSRC_DIR / f"{source}.cu").read_text()
    text = text[text.index('extern "C" {'):]
    return {m.group(1): len([a for a in m.group(2).split(",") if a.strip()])
            for m in _ENTRY.finditer(text)}


def _constant(source: str, name: str) -> int:
    """The value of ``constexpr int <name> = <arithmetic>;`` in a source."""
    text = (CSRC_DIR / f"{source}.cu").read_text()
    m = re.search(rf"constexpr int {name} = ([\d\s*/+-]+);", text)
    assert m, f"{name} not found in {source}.cu"
    return int(eval(m.group(1), {"__builtins__": {}}))


@pytest.mark.parametrize("source,fn", [
    (s, f) for s in sorted(SIGNATURES) for f in sorted(SIGNATURES[s])])
def test_entry_point_takes_its_bound_signature(source, fn):
    assert source in SOURCES
    entries = _entry_points(source)
    assert fn in entries, f"{fn} is not an entry point of {source}.cu"
    assert entries[fn] == len(SIGNATURES[source][fn])


@pytest.mark.parametrize("source", sorted(SIGNATURES))
def test_every_entry_point_is_bound(source):
    """No C entry point is left without a signature (nothing the wrappers
    do not call is compiled into a kernel library's interface)."""
    assert set(_entry_points(source)) == set(SIGNATURES[source])


def test_decode_plan_constants_are_the_kernels():
    """K6's chunk and ring budget: the host's decode_chunk_keys mirrors
    Dec::kBC from these."""
    src = "pul_dense_attention"
    assert _constant(src, "kDecChunkBytes") == pul_decode.DECODE_CHUNK_BYTES
    assert _constant(src, "kDecSmemBytes") == pul_decode.DECODE_SMEM_BYTES
    assert _constant(src, "kDecWarps") == pul_decode.DECODE_WARPS


def test_filter_plan_constants_are_the_kernels():
    src = "pul_filter"
    assert _constant(src, "kMaxUnloadSlots") == pul_filter.MAX_UNLOAD_SLOTS
    assert _constant(src, "kMaxBoxRows") == pul_filter.MAX_BOX_ROWS
    assert _constant(src, "kThreads") == 128


def test_probe_is_no_kernel_library():
    """The sector probe is a measuring aid with its own source: no kernel
    library exports it or changes the device's L2 fetch granularity."""
    assert (CSRC_DIR / "probes" / "sector_probe.cu").exists()
    for source in SOURCES:
        text = (CSRC_DIR / f"{source}.cu").read_text()
        assert "cudaDeviceSetLimit" not in text, source
