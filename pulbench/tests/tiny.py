"""The benchmark's cells cut to a size the CPU runs in seconds: the same
configuration files, traffic files and cell files, with every width and
count shrunk (these sizes stand for nothing; they drive the code): the
published keys that the configuration's family lists in its ``TINY``. The
weights' scale is that of the published widths' fan-in (0.02 at 2,048 is
about 1/sqrt(2,048)), 1/sqrt(64) here, so that the layers, not the
embedding, carry the residual stream as they do at full width."""
from __future__ import annotations

import copy
import dataclasses

from pulbench import families, spec

TRAFFIC = {
    "closed_batch": {"sessions": 4, "admit_per_step": 2, "sample": 2,
                     "prompt": {"dist": "loguniform", "lo": 40, "hi": 120},
                     "output": {"tokens": 64},
                     "engine": {"batch_slots": 4, "max_seq": 192,
                                "hot_pages": 0,
                                "prefill_buckets": [64, 128]}},
    "closed_loop": {"clients": 4, "warm_completions": 4, "pool": 64,
                    "strata": 4, "sample": 4,
                    "prompt": {"dist": "lognormal", "median": 32,
                               "sigma": 0.7, "lo": 16, "hi": 64},
                    "output": {"dist": "lognormal", "median": 12,
                               "sigma": 0.5, "lo": 6, "hi": 24},
                    "engine": {"batch_slots": 4, "max_seq": 128,
                               "prefill_buckets": [32, 64]}},
}


def _merge(base, over):
    out = copy.deepcopy(base)
    for k, v in over.items():
        nested = isinstance(v, dict) and isinstance(out.get(k), dict)
        if nested and k != "prompt":
            out[k] = _merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def tiny_cell(workload: str, limit: float = 1.0) -> spec.Cell:
    cell = spec.cell(workload)
    cfg = _merge(cell.config, families.of(cell.config).TINY)
    mix = _merge(cell.traffic, TRAFFIC[cell.traffic["mode"]])
    limits = {"logit_gap": {"limit": limit}, "compared_tokens": {"limit": 8}}
    return dataclasses.replace(cell, config=cfg, traffic=mix, limits=limits)
