"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100 (SXM).

    python3 chip_smoke.py

Phases, one line each; every phase runs, and any failure propagates so the
exit code is not 0:

  1. device   -- card name and power limit (nvidia-smi), copy rates that feed
                 the H100 tiers of ``repro_torch.core.pul``
  2. build    -- compile the CUDA kernels from ``src/repro_torch/csrc``
  3. kernels  -- K1/K2 against their plain PyTorch versions at qwen3-1.7b
                 widths (bf16, two bf16 ulps of each row's largest value),
                 planted faults that the limit must reject, times, byte
                 bounds and plain times
  4. serving  -- full-width qwen3-1.7b (random weights from seed 0) served
                 by the paged engine through K1 (fused sweep)
  5. serving  -- the same script through K2 (per-layer): bitwise-equal tokens
  6. summary  -- one JSON line listing the kernels
  7. last line: {"ok": true, "device": {...}}

Where a decode tick's time goes (device busy share, top kernels) is a
one-off measurement, not a phase:

    python3 -c "import chip_smoke; chip_smoke.profile_decode()"

Imports only torch, numpy and ``repro_torch`` (from ``src/`` beside this
file); exits non-zero without CUDA.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import IssueStrategy, PULConfig  # noqa: E402
from repro_torch.core.planner import plan_kv_page_stream  # noqa: E402
from repro_torch.core.pul import H100_PINNED_HOST, H100_SM  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import pul_attention as PA  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    PagedEngineConfig, PagedServingEngine, Request)

# qwen3-1.7b widths and the serving geometry of phases 4-5
H, KV, HD, P, L = 16, 8, 128, 16, 28
SLOTS, MAX_SEQ = 8, 1024
# published peaks of the H100 SXM (NVIDIA data sheet, 700 W): HBM bytes/s
# and float32 flop/s outside the tensor cores, where the kernels do their math
H100_SXM = "H100 80GB HBM3"
HBM_PEAK, FP32_PEAK = 3.35e12, 67e12


def _bf16_limit(want):
    """Two bf16 ulps of each (b, h) row's largest |value|: room for one
    rounding flip after the card sums in another order, and no more."""
    top = want.float().abs().amax(dim=-1, keepdim=True)
    return 2.0 * torch.exp2(torch.floor(torch.log2(top.clamp_min(2.0 ** -126))) - 7)


def _close(got, want):
    return bool(((got.float() - want.float()).abs() <= _bf16_limit(want)).all())


def _check(got, want, what):
    if not _close(got, want):
        err = (got.float() - want.float()).abs() / _bf16_limit(want)
        raise AssertionError(f"{what}: error up to {err.max().item():.1f} x the "
                             "limit of two bf16 ulps of the row's largest value")


def _smi(query):
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def _time_ms(fn, reps=20, warmup=3):
    """Median of per-call CUDA-event times, in ms. The card is kept busy
    while the host enqueues each call, so the interval is device time, not
    launch overhead."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(5_000_000)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# ---------------------------------------------------------------------- #
def phase_device():
    name_limit = _smi("name,power.limit")
    kind = torch.cuda.get_device_name(0)
    sm_clock = _smi("clocks.max.sm")
    dev = torch.device("cuda")
    n = 256 * 2**20
    host = torch.empty(n, dtype=torch.uint8).pin_memory()
    dst = torch.empty(n, dtype=torch.uint8, device=dev)
    h2d_ms = _time_ms(lambda: dst.copy_(host, non_blocking=True), reps=10)
    big = torch.empty(2**30, dtype=torch.uint8, device=dev)
    big2 = torch.empty_like(big)
    d2d_ms = _time_ms(lambda: big2.copy_(big), reps=10)
    page = 4096
    small_h = torch.empty(page, dtype=torch.uint8).pin_memory()
    small_d = torch.empty(page, dtype=torch.uint8, device=dev)
    small_d2 = torch.empty_like(small_d)
    h2d_lat = _time_ms(lambda: small_d.copy_(small_h, non_blocking=True), reps=200)
    d2d_lat = _time_ms(lambda: small_d2.copy_(small_d), reps=200)
    info = {
        "smi": name_limit, "kind": kind, "sm_clock_max": sm_clock,
        "h2d_pinned_GBps": n / h2d_ms / 1e6,
        "d2d_copy_GBps": 2**30 / d2d_ms / 1e6,
        "d2d_read_write_GBps": 2 * 2**30 / d2d_ms / 1e6,
        "h2d_4KiB_us": h2d_lat * 1e3, "d2d_4KiB_us": d2d_lat * 1e3,
    }
    print(name_limit)
    print("[device] " + json.dumps(info))
    del host, dst, big, big2
    torch.cuda.empty_cache()
    return info


def phase_build():
    t0 = time.perf_counter()
    path = _build.build(PA._SOURCE)
    PA._lib()
    secs = time.perf_counter() - t0
    ptxas = " | ".join(line.strip() for line in
                       str(_build.BUILD_INFO[PA._SOURCE]["ptxas"]).splitlines()
                       if "registers" in line or "spill" in line)
    print(f"[build] {path.name} in {secs:.2f} s; ptxas: {ptxas}")
    return secs


def engine_distance():
    """The preload distance the engine binds at full width (planner d* on
    the port's default tiers, clamped to the FIFO as the engine does)."""
    plan = plan_kv_page_stream(page_tokens=P, kv_features=2 * L * KV * HD,
                               tier=H100_PINNED_HOST, pe=H100_SM,
                               gqa_group=H // KV)
    return max(1, min(plan.cfg.distance, plan.cfg.fifo_depth))


def _kernel_case(gen, dev, lengths, *, softcap=None, window=None):
    B = len(lengths)
    n_pages = MAX_SEQ // P
    NF = B * n_pages + 4
    planes_k = torch.randn((L, NF, KV, P, HD), generator=gen, device=dev,
                           dtype=torch.bfloat16)
    planes_v = torch.randn((L, NF, KV, P, HD), generator=gen, device=dev,
                           dtype=torch.bfloat16)
    perm = torch.randperm(NF - 2, generator=gen, device=dev)[:B * n_pages] + 2
    pt = perm.reshape(B, n_pages).to(torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    q = torch.randn((B, H, HD), generator=gen, device=dev, dtype=torch.bfloat16)
    kn = torch.randn((B, KV, HD), generator=gen, device=dev, dtype=torch.bfloat16)
    vn = torch.randn((B, KV, HD), generator=gen, device=dev, dtype=torch.bfloat16)
    frames = pt.gather(1, (lens // P).long()[:, None])[:, 0].contiguous()
    frames[lens == 0] = 1                    # an idle slot writes the TRASH frame
    offs = (lens % P).to(torch.int32)
    return dict(q=q, kp=planes_k, vp=planes_v, pt=pt, lens=lens, kn=kn, vn=vn,
                frames=frames, offs=offs, softcap=softcap, window=window)


def _bound(c):
    """Least time for the kernel's work on this card: bytes each input read
    once and each output written once over the HBM peak, against the fp32
    flops of the visible positions over the fp32 peak."""
    lens = c["lens"].tolist()
    w = c["window"]
    toks = 0
    slab_bytes = 0
    for n in lens:
        lo = max(0, n - w + 1) // P if w else 0
        pages = max(0, -(-n // P) - lo)
        slab_bytes += pages * P * HD * 2 * 2 * KV          # K and V, per kv head
        toks += (n - (max(0, n - w + 1) if w else 0)) + 1
    small = sum(t.numel() * t.element_size() for t in
                (c["q"], c["kn"], c["vn"], c["pt"], c["lens"]))
    small += c["q"].numel() * 2                             # out
    nbytes = slab_bytes + small
    t_bytes = nbytes / HBM_PEAK * 1e3
    t_ops = 4.0 * H * HD * toks / FP32_PEAK * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            nbytes)


def _planted_faults(c, want, layer, kw):
    """Wrong answers the limit must reject, on the mixed case: the last
    visible page of the length-1000 row skipped, and the current token not
    folded in."""
    row = c["lens"].tolist().index(1000)
    cut = c["lens"].clone()
    cut[row] = 1000 // P * P
    faults = {
        "last page of the length-1000 row skipped":
            PA.paged_decode_attention_ref(
                c["q"], c["kp"][layer], c["vp"][layer], c["pt"], cut,
                k_new=c["kn"], v_new=c["vn"], **kw),
        "current token not folded":
            PA.paged_decode_attention_ref(
                c["q"], c["kp"][layer], c["vp"][layer], c["pt"], c["lens"], **kw),
    }
    for what, bad in faults.items():
        if _close(bad, want):
            raise AssertionError(f"the bf16 limit lets a planted fault through: "
                                 f"{what}")
    print(f"[kernels] planted faults rejected by the limit: {', '.join(faults)}")


def phase_kernels():
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    d_eng = engine_distance()
    cases = [
        ("mixed", dict(lengths=[0, 7, 16, 1000, 513, 250, 64, 999])),
        ("softcap+window", dict(lengths=[5, 300, 16, 777, 0, 1023, 48, 129],
                                softcap=30.0, window=100)),
    ]
    results = {"k1": [], "k2": []}
    for label, spec in cases:
        c = _kernel_case(gen, dev, **spec)
        ring = [PULConfig(distance=d) for d in sorted({1, d_eng})]
        ring.append(PULConfig(distance=d_eng, strategy=IssueStrategy.SEQUENTIAL))
        for cfg in ring:
            d = f"{cfg.distance}{'' if cfg.strategy is IssueStrategy.BATCH else ' seq'}"
            layer = 17
            kw = dict(scale=1.0 / math.sqrt(HD), softcap=c["softcap"],
                      window=c["window"])
            # K2 first (it reads the pre-commit planes), then K1
            out2 = PA.pul_paged_decode_attention(
                c["q"], c["kp"][layer], c["vp"][layer], c["pt"], c["lens"],
                cfg=cfg, k_new=c["kn"], v_new=c["vn"], **kw)
            kp0, vp0 = c["kp"].clone(), c["vp"].clone()
            out1 = PA.pul_paged_sweep_decode_attention(
                c["q"], c["kp"], c["vp"], layer, c["pt"], c["lens"], c["kn"],
                c["vn"], c["frames"], c["offs"], cfg=cfg, **kw)
            torch.cuda.synchronize()
            want = PA.paged_sweep_decode_attention_ref(
                c["q"], kp0, vp0, layer, c["pt"], c["lens"], c["kn"], c["vn"],
                c["frames"], c["offs"], **kw)
            err1 = (out1.float() - want.float()).abs().max().item()
            err2 = (out2.float() - want.float()).abs().max().item()
            _check(out1, want, f"{label} d={d}: K1")
            _check(out2, want, f"{label} d={d}: K2")
            # K2 without a current token (an empty slot then gives 0)
            _check(PA.pul_paged_decode_attention(
                       c["q"], kp0[layer], vp0[layer], c["pt"], c["lens"],
                       cfg=cfg, **kw),
                   PA.paged_decode_attention_ref(
                       c["q"], kp0[layer], vp0[layer], c["pt"], c["lens"], **kw),
                   f"{label} d={d}: K2 without a current token")
            if not torch.equal(out1, out2):
                raise AssertionError(f"{label} d={d}: K1 out != K2 out bitwise")
            # committed rows bitwise, every other plane row unchanged
            if not (torch.equal(c["kp"], kp0) and torch.equal(c["vp"], vp0)):
                raise AssertionError(f"{label} d={d}: K1 commit differs from "
                                     "the plain version's")
            if label == "mixed" and cfg is ring[0]:
                _planted_faults(dict(c, kp=kp0, vp=vp0), want, layer, kw)
            del kp0, vp0
            results["k1"].append(err1)
            results["k2"].append(err2)
            print(f"[kernels] {label} d={d}: max|K1-plain| {err1:.3e} "
                  f"max|K2-plain| {err2:.3e} (limit: two bf16 ulps of each "
                  "row's largest value) K1==K2 bitwise")
        del c
    # timing at the mixed case's shapes with the engine distance
    c = _kernel_case(gen, dev, **cases[0][1])
    cfg = PULConfig(distance=d_eng)
    kw = dict(scale=1.0 / math.sqrt(HD), softcap=None, window=None)
    layer = 5
    k1_ms = _time_ms(lambda: PA.pul_paged_sweep_decode_attention(
        c["q"], c["kp"], c["vp"], layer, c["pt"], c["lens"], c["kn"], c["vn"],
        c["frames"], c["offs"], cfg=cfg, **kw))
    k2_ms = _time_ms(lambda: PA.pul_paged_decode_attention(
        c["q"], c["kp"][layer], c["vp"][layer], c["pt"], c["lens"], cfg=cfg,
        k_new=c["kn"], v_new=c["vn"], **kw))
    plain1_ms = _time_ms(lambda: PA.paged_sweep_decode_attention_ref(
        c["q"], c["kp"], c["vp"], layer, c["pt"], c["lens"], c["kn"], c["vn"],
        c["frames"], c["offs"], **kw), reps=10)
    plain2_ms = _time_ms(lambda: PA.paged_decode_attention_ref(
        c["q"], c["kp"][layer], c["vp"][layer], c["pt"], c["lens"],
        k_new=c["kn"], v_new=c["vn"], **kw), reps=10)
    bound_ms, bound_by, nbytes = _bound(c)
    print(f"[kernels] B=8 lengths {c['lens'].tolist()} d={d_eng}: K1 {k1_ms:.4f} ms"
          f" K2 {k2_ms:.4f} ms; plain {plain1_ms:.4f} / {plain2_ms:.4f} ms; "
          f"bound {bound_ms:.5f} ms ({bound_by}, {nbytes} B)")
    return {
        "k1": dict(max_abs_err=max(results["k1"]), ms=k1_ms, plain_ms=plain1_ms,
                   bound_ms=bound_ms, bound_by=bound_by),
        "k2": dict(max_abs_err=max(results["k2"]), ms=k2_ms, plain_ms=plain2_ms,
                   bound_ms=bound_ms, bound_by=bound_by),
    }


class _CheckedEngine(PagedServingEngine):
    """The engine with every emitted logit row checked for finiteness."""

    def _emit_token(self, slot, logits):
        if not np.isfinite(logits).all():
            raise AssertionError(f"non-finite logits for slot {slot}")
        super()._emit_token(slot, logits)


def _requests(vocab):
    """12 prompts of 20-500 tokens; requests 1 and 2 (100 and 120 tokens,
    both in the 128 bucket) share their first 64 tokens."""
    rng = np.random.default_rng(0)
    lens = [20, 100, 120, 500, 333, 47, 256, 64, 180, 401, 77, 128]
    prompts = [rng.integers(1, vocab, size=n).tolist() for n in lens]
    prompts[2][:64] = prompts[1][:64]
    return [Request(rid=i, prompt=p, max_new_tokens=24)
            for i, p in enumerate(prompts)]


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _engine(cfg, params, sweep, device):
    return _CheckedEngine(cfg, params, PagedEngineConfig(
        batch_slots=SLOTS, max_seq=MAX_SEQ, page_tokens=P,
        prefill_buckets=(128, 256, 512), use_paged_kernel=True,
        sweep_decode=sweep, device=device))


def warm_up(cfg, params, device="cuda"):
    """One short request per prefill bucket through both decode paths, so
    the timed runs below pay no first-call cost (library handles, kernel
    module load, allocator growth)."""
    for sweep in (True, False):
        eng = _engine(cfg, params, sweep, device)
        for i, n in enumerate((100, 200, 400)):
            eng.submit(Request(rid=i, prompt=[1 + i] * n, max_new_tokens=3))
        eng.run()
    _sync(device)


def phase_serving(cfg, params, *, sweep, device="cuda"):
    """Serve the request script through K1 (sweep) or K2 (per layer), with
    one preempt/resume mid-stream."""
    key = "k1" if sweep else "k2"
    layers = cfg.num_layers
    eng = _engine(cfg, params, sweep, device)
    for r in _requests(cfg.vocab_size):
        eng.submit(r)
    decode_ms = []              # host time of ticks that ran no prefill

    def step():
        n = eng.metrics.prefills
        t = time.perf_counter()
        eng.step()              # ends in a device-to-host copy of the logits
        if eng.metrics.prefills == n:
            decode_ms.append((time.perf_counter() - t) * 1e3)

    for k in PA.LAUNCHES:
        PA.LAUNCHES[k] = 0
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(6):
        step()
    victim = eng._live_slots()[0]
    eng.preempt(victim)
    for _ in range(3):
        step()
    eng.resume(victim)
    while len(eng.scheduler) or any(r is not None for r in eng.slot_req):
        step()
    out = {rid: r.out_tokens for rid, r in eng.requests.items()}
    _sync(device)
    wall = time.perf_counter() - t0
    launches = dict(PA.LAUNCHES)
    m, pm = eng.metrics, eng.pool.metrics
    pm.validate()
    if sorted(out) != list(range(12)) or any(len(v) != 24 for v in out.values()):
        raise AssertionError(f"not every request finished: "
                             f"{ {k: len(v) for k, v in out.items()} }")
    if launches[key] != layers * m.decode_steps:
        raise AssertionError(f"{key} launched {launches[key]} times, expected "
                             f"{layers} x {m.decode_steps} decode steps")
    other = "k2" if sweep else "k1"
    if launches[other]:
        raise AssertionError(f"{other} launched on the {key} path")
    if pm.page_faults < 1 or pm.shared_hits < 1:
        raise AssertionError(f"page_faults {pm.page_faults}, shared_hits "
                             f"{pm.shared_hits}: the cold tier or prefix "
                             "sharing did not run")
    stats = {"path": "sweep (K1)" if sweep else "per-layer (K2)",
             "ticks": m.ticks, "decode_steps": m.decode_steps,
             "prefills": m.prefills, "tokens": m.tokens_emitted,
             "launches": launches[key], "wall_s": wall,
             "tokens_per_s": m.tokens_emitted / wall,
             "ms_per_tick": wall / m.ticks * 1e3,
             "decode_tick_ms_median": statistics.median(decode_ms),
             "decode_ticks": len(decode_ms),
             "page_faults": pm.page_faults, "evictions": pm.evictions,
             "shared_hits": pm.shared_hits,
             "bytes_hot_written": pm.bytes_hot_written,
             "preload_distance": eng.pul_distance}
    print("[serving] " + json.dumps(stats))
    del eng
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return out, stats


def profile_decode():
    """One-off, not a phase of the smoke: where a decode tick's time goes.
    torch.profiler over 4 pure decode ticks of the sweep path at full width
    (8 requests, all admitted at tick 0). Prints one [profile] line."""
    from torch.profiler import ProfilerActivity, profile
    cfg = get_config("qwen3-1.7b")
    params = init_params(cfg, seed=0, device="cuda")
    warm_up(cfg, params)
    eng = _engine(cfg, params, True, "cuda")
    for r in _requests(cfg.vocab_size)[:8]:
        eng.submit(r)
    for _ in range(3):
        eng.step()
    n_prefills = eng.metrics.prefills
    ticks = 4
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ticks):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if eng.metrics.prefills != n_prefills:
        raise AssertionError("a prefill ran inside the decode window")
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise AssertionError("the profiler recorded no device activity")
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    ops = sum(1 for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CPU
              and e.name.startswith("aten::") and e.cpu_parent is None)
    stats = {"smi": _smi("name,power.limit"), "ticks": ticks,
             "wall_ms_per_tick": wall * 1e3 / ticks,
             "device_busy_ms_per_tick": busy / ticks,
             "device_idle_share": 1.0 - busy / (wall * 1e3),
             "kernels_per_tick": len(kernels) / ticks,
             "top_level_aten_ops_per_tick": ops / ticks,
             "top_kernels_ms_per_tick": [(n[:60], ms / ticks) for n, ms in top]}
    print("[profile] " + json.dumps(stats))
    return stats


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    kind = torch.cuda.get_device_name(0)
    if H100_SXM not in kind:
        raise RuntimeError(f"{kind!r} is not an H100 SXM; the bounds use its "
                           "published peaks")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = _smi("name,power.limit")
    t0 = time.perf_counter()
    phase_device()
    phase_build()
    kern = phase_kernels()
    cfg = get_config("qwen3-1.7b")
    params = init_params(cfg, seed=0, device="cuda")
    warm_up(cfg, params)
    out1, s1 = phase_serving(cfg, params, sweep=True)
    out2, s2 = phase_serving(cfg, params, sweep=False)
    if out1 != out2:
        raise AssertionError("per-layer (K2) tokens differ from the sweep "
                             "(K1) tokens")
    if s1["bytes_hot_written"] != s2["bytes_hot_written"]:
        raise AssertionError("bytes_hot_written differs between the paths")
    print(f"[serving] K2 tokens == K1 tokens bitwise over "
          f"{sum(len(v) for v in out1.values())} tokens")
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    rows = []
    for key, stats, name, line in (
            ("k1", s1, "pul_paged_sweep_decode_attention", 406),
            ("k2", s2, "pul_paged_decode_attention", 152)):
        rows.append({"name": name, "route": "cuda",
                     "source": "src/repro_torch/csrc/pul_paged_decode.cu",
                     "replaces": f"src/repro/kernels/pul_attention.py:{line}",
                     "launches": stats["launches"],
                     **{k: kern[key][k] for k in (
                         "max_abs_err", "ms", "plain_ms", "bound_ms",
                         "bound_by")},
                     "library_ms": None})
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
