"""The plain PyTorch versions of the port's kernels, under the reference's
names (``repro/kernels/ref.py``): the allclose targets of the tests and of
``chip_smoke.py``. Each lives beside its kernel; this module gathers them.
The attention oracles (``attention_ref``, ``decode_attention_ref``) come
with K6/K7 (ROADMAP, port queue item 1)."""
from repro_torch.kernels.pul_filter import filter_materialize_ref, filter_ref
from repro_torch.kernels.pul_gather import gather_ref
from repro_torch.kernels.pul_matmul import matmul_ref
from repro_torch.kernels.pul_sum import sum_ref

__all__ = ["sum_ref", "gather_ref", "matmul_ref", "filter_ref",
           "filter_materialize_ref"]
