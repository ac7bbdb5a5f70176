"""What the port's serving scripts share: the decode paths they name, the
model they load, their baselines, and the timed tick loop."""
from __future__ import annotations

import os
import time

#: the port's own gate baselines (never the reference's, which hold
#: fractions against another chip's constants)
BASELINES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "baselines")

#: the paged engine's decode paths, as the serving scripts name them:
#: kernel-true fused sweep (K1; the main path), kernel-true per layer (K2),
#: and dense assembly through the PUL gather (K5)
DECODE_PATHS = {
    "sweep": dict(use_paged_kernel=True, sweep_decode=True),
    "per-layer": dict(use_paged_kernel=True, sweep_decode=False),
    "assembly": dict(use_paged_kernel=False, use_pallas_gather=True),
}


def default_baseline(name: str, reduced: bool) -> str:
    """The port's baseline `name` (``serving``, ``roofline_serving``) for
    the full-width geometry, or for the reduced one."""
    return os.path.join(BASELINES,
                        f"{name}_reduced.json" if reduced else f"{name}.json")


def load_model(arch: str, *, reduced: bool, device: str, seed: int = 0):
    """(config, random params from `seed` on `device`, parameter count)."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    params = init_params(cfg, seed=seed, device=device)
    return cfg, params, n_params_of(params)


def n_params_of(params) -> int:
    from repro_torch.models.module import flatten
    return int(sum(t.numel() for _, t in flatten(params)))


def tick_s(eng) -> float:
    """One engine tick's host seconds (a decode tick ends in the logits'
    copy to the host, so it waits for the device), less what the engine's
    ``check_s`` grew by meanwhile: the host time a checking subclass spends
    on its own recording, which times the check and not the engine."""
    c = getattr(eng, "check_s", 0.0)
    t = time.perf_counter()
    eng.step()
    return time.perf_counter() - t - (getattr(eng, "check_s", 0.0) - c)


def timed_run(eng, max_ticks: int = 1000):
    """Drive `eng` as ``PagedServingEngine.run`` does, timing each tick;
    returns [(host seconds, whether the tick ran a prefill)]."""
    ticks = []
    while eng.pending() and len(ticks) < max_ticks:
        n = eng.metrics.prefills
        ticks.append((tick_s(eng), eng.metrics.prefills != n))
    return ticks
