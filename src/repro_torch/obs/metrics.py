"""Flat metrics registry + the ROADMAP's cache-economics accounting.

:class:`MetricsRegistry` is a deliberately small, dependency-free metric
store — named scalar samples with optional labels — exportable as JSON (for
``BENCH_*.json`` reports) and as Prometheus text exposition format (for
scraping a long-lived serving process). It is *pull*-shaped: the engine
fills a fresh registry from its counters at snapshot time, so there is no
per-tick registry traffic on the hot path and an untraced run allocates
nothing here either.

:func:`cache_economics` is the ROADMAP "bytes moved per token emitted, per
tier" metric plus the prefetch-quality triple from the prefetching survey
(Shakerinava et al., PAPERS.md) applied to planned d* page restores:

  * **accuracy**   — fraction of preloaded (restored) pages that were read
    before being evicted again. The pool marks each restore and clears the
    mark at first read; a page evicted still-unread was a wasted preload.
  * **timeliness** — fraction of restore access latency the planned d*
    schedule hid (the DMA twin's modeled stall vs total restore time) —
    the paper's headline quantity, per serving run.
  * **coverage**   — fraction of cold-page demands served by a *planned*
    preload batch rather than an unplanned demand stall. Today every
    restore flows through ``ensure_hot``'s planned batch, so coverage is
    1.0 by construction; the counter exists so a future speculative d*
    planner that misses demands becomes visible, not invisible.
"""
from __future__ import annotations

import dataclasses
import json
import re
from typing import Any, Dict, List, Optional, Tuple

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    """Sanitize to Prometheus metric-name charset."""
    return _NAME_RE.sub("_", name)


def _prom_label_value(value: Any) -> str:
    s = str(value)
    return s.replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")


@dataclasses.dataclass(frozen=True)
class Sample:
    name: str
    value: float
    labels: Tuple[Tuple[str, str], ...] = ()


class MetricsRegistry:
    """Named scalar samples with labels; JSON + Prometheus exporters."""

    def __init__(self) -> None:
        self._samples: "Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float]" = {}
        self._help: Dict[str, str] = {}

    def set(self, name: str, value: float, *, help: str = "",
            **labels: Any) -> None:
        key = (name, tuple(sorted((k, str(v)) for k, v in labels.items())))
        self._samples[key] = float(value)
        if help:
            self._help[name] = help

    def inc(self, name: str, value: float = 1.0, **labels: Any) -> None:
        key = (name, tuple(sorted((k, str(v)) for k, v in labels.items())))
        self._samples[key] = self._samples.get(key, 0.0) + float(value)

    def get(self, name: str, **labels: Any) -> Optional[float]:
        key = (name, tuple(sorted((k, str(v)) for k, v in labels.items())))
        return self._samples.get(key)

    def samples(self) -> List[Sample]:
        return [Sample(name=n, value=v, labels=lbls)
                for (n, lbls), v in sorted(self._samples.items())]

    # ------------------------------------------------------------------ #
    def to_json(self) -> Dict[str, Any]:
        """Flat JSON: {name: [{labels: {...}, value: v}, ...]}."""
        out: Dict[str, Any] = {}
        for s in self.samples():
            out.setdefault(s.name, []).append(
                {"labels": dict(s.labels), "value": s.value})
        return out

    def dump_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2, sort_keys=True)

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (gauges; one line/sample)."""
        lines: List[str] = []
        last_name = None
        for s in self.samples():
            name = _prom_name(s.name)
            if name != last_name:
                if s.name in self._help:
                    lines.append(f"# HELP {name} {self._help[s.name]}")
                lines.append(f"# TYPE {name} gauge")
                last_name = name
            if s.labels:
                lbl = ",".join(f'{_prom_name(k)}="{_prom_label_value(v)}"'
                               for k, v in s.labels)
                lines.append(f"{name}{{{lbl}}} {s.value:g}")
            else:
                lines.append(f"{name} {s.value:g}")
        return "\n".join(lines) + ("\n" if lines else "")

    def dump_prometheus(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_prometheus())


# ---------------------------------------------------------------------- #
# cache economics
# ---------------------------------------------------------------------- #
def cache_economics(*, page_bytes: int, tokens_emitted: int,
                    pool_metrics) -> Dict[str, Any]:
    """Bytes moved per token emitted, per tier, + prefetch quality.

    `pool_metrics` is a ``serving.kv_pages.PoolMetrics``.

    Tier accounting (bytes, from the pool's own counters):
      * ``hot``  — traffic into/out of the fast tier: restores land here
        (in), evictions leave here (out), plus the pool's own scatter
        traffic ``bytes_hot_written`` (prefill page fills and decode row
        writes — they originate on-device but are real HBM write
        bandwidth).
      * ``cold`` — the spill tier: evictions land here (in), restores are
        read back out (out).
    """
    pm = pool_metrics
    tokens = max(tokens_emitted, 1)
    fills = getattr(pm, "bytes_hot_written", 0)
    tiers = {
        "hot": {
            "bytes_in": pm.page_faults * page_bytes + fills,
            "bytes_out": pm.evictions * page_bytes,
        },
        "cold": {
            "bytes_in": pm.evictions * page_bytes,
            "bytes_out": pm.page_faults * page_bytes,
        },
    }
    for t in tiers.values():
        t["bytes_moved"] = t["bytes_in"] + t["bytes_out"]
        t["bytes_per_token"] = t["bytes_moved"] / tokens

    useful = getattr(pm, "useful_preloads", 0)
    wasted = getattr(pm, "wasted_preloads", 0)
    planned = getattr(pm, "planned_preloads", 0)
    unplanned = getattr(pm, "unplanned_restores", 0)
    prefetch = {
        "accuracy": (useful / (useful + wasted)) if (useful + wasted) else 1.0,
        "timeliness": pm.modeled_latency_hidden,
        "coverage": (planned / (planned + unplanned))
                    if (planned + unplanned) else 1.0,
        "planned_preloads": planned,
        "unplanned_restores": unplanned,
        "useful_preloads": useful,
        "wasted_preloads": wasted,
    }
    return {
        "tokens_emitted": tokens_emitted,
        "page_bytes": page_bytes,
        "tiers": tiers,
        "prefetch": prefetch,
    }


def serving_roofline(*, econ: Dict[str, Any], n_params: int,
                     tokens_emitted: int, peak_flops: float,
                     hot_bw: float, cold_bw: float) -> Dict[str, Any]:
    """Achieved-vs-peak bandwidth per tier for a paged serving run.

    Roofline accounting over the :func:`cache_economics` byte counters:
    the modeled run time is the critical path of decode compute
    (``2 * n_params`` FLOPs/token against ``peak_flops``) and each tier's
    transfer time (``bytes_moved`` against that tier's peak bandwidth,
    compute/IO fully overlapped — the PUL preload assumption). Each tier's
    ``bw_fraction`` is the share of its peak bandwidth the run sustains
    over that critical path; the dominant term scores 1.0.

    Everything here derives from tick-deterministic pool counters and
    fixed hardware constants — NOT wall time — so the numbers are bitwise
    reproducible and safe to gate in CI against a checked-in baseline.
    """
    tokens = max(tokens_emitted, 1)
    t_compute = tokens * 2.0 * n_params / peak_flops
    peak = {"hot": hot_bw, "cold": cold_bw}
    t_tier = {tier: econ["tiers"][tier]["bytes_moved"] / peak[tier]
              for tier in ("hot", "cold")}
    t_model = max(t_compute, *t_tier.values())
    terms = {"compute": t_compute, **t_tier}
    tiers = {}
    for tier, bw in peak.items():
        moved = econ["tiers"][tier]["bytes_moved"]
        tiers[tier] = {
            "bytes_moved": moved,
            "bytes_per_token": econ["tiers"][tier]["bytes_per_token"],
            "peak_bw": bw,
            "achieved_bw": moved / t_model,
            "bw_fraction": t_tier[tier] / t_model,
        }
    return {
        "tokens_emitted": tokens_emitted,
        "n_params": n_params,
        "modeled": {"compute_s": t_compute, "hot_s": t_tier["hot"],
                    "cold_s": t_tier["cold"], "critical_path_s": t_model,
                    "dominant": max(terms, key=terms.get)},
        "tiers": tiers,
    }


def economics_into_registry(reg: MetricsRegistry, econ: Dict[str, Any],
                            **labels: Any) -> None:
    """Flatten a :func:`cache_economics` dict into registry samples."""
    for tier, t in econ["tiers"].items():
        for k in ("bytes_in", "bytes_out", "bytes_moved", "bytes_per_token"):
            reg.set(f"pul_cache_{k}", t[k], tier=tier,
                    help=f"cache-economics {k} per tier", **labels)
    for k in ("accuracy", "timeliness", "coverage"):
        reg.set(f"pul_prefetch_{k}", econ["prefetch"][k],
                help=f"prefetch {k} of planned d* restores", **labels)
    reg.set("pul_tokens_emitted", econ["tokens_emitted"], **labels)
