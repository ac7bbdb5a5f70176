"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100 (SXM).

    python3 chip_smoke.py

Phases, one line each; every phase runs, and any failure propagates so the
exit code is not 0:

  1. device       -- card name and power limit (nvidia-smi), copy rates that
                     feed the H100 tiers of ``repro_torch.core.pul``
  2. build        -- compile the CUDA sources of ``src/repro_torch/csrc``, one
                     nvcc each, all started together
  3. kernels      -- K1/K2 against their plain PyTorch versions at qwen3-1.7b
                     widths (bf16, two bf16 ulps of each row's largest value),
                     planted faults that the limit must reject, times, bounds
                     and plain times
  4. kernels-mla  -- the same for K3/K4 at deepseek-v2 widths
  5. serving      -- full-width qwen3-1.7b (random weights from seed 0) served
                     by the paged engine through K1 (fused sweep), then the
                     same script through K2 (per layer): bitwise-equal tokens
  6. serving-mla  -- full-width deepseek-v2-236b, depth cut to 6 layers (the
                     dense layer 0 and 5 MoE layers), the same script through
                     K3 and then K4: bitwise-equal tokens
  7. summary      -- one JSON line listing the kernels
  8. last line: {"ok": true, "device": {...}}

Where a decode tick's time goes (device busy share, top kernels) is a
one-off measurement, not a phase:

    python3 -c "import chip_smoke; chip_smoke.profile_decode()"
    python3 -c "import chip_smoke; chip_smoke.profile_decode('deepseek-v2-236b')"

Imports only torch, numpy and ``repro_torch`` (from ``src/`` beside this
file); exits non-zero without CUDA.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

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
from repro_torch.models.module import flatten  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    PagedEngineConfig, PagedServingEngine, Request)

# qwen3-1.7b widths and the serving geometry of the serving phases
H, KV, HD, P, L = 16, 8, 128, 16, 28
SLOTS, MAX_SEQ = 8, 1024
# deepseek-v2-236b widths (MLA: 128 heads, kv_lora 512, rope 64, qk 128 + 64)
# and the smoke's one cut, depth: the dense layer 0 and 5 MoE layers
DEEPSEEK = "deepseek-v2-236b"
MLA_H, KVR, DR, MLA_QK = 128, 512, 64, 128 + 64
MLA_LAYERS = 6
# published peaks of the H100 SXM (NVIDIA data sheet, 700 W): HBM bytes/s,
# dense bf16 tensor-core flop/s, the peak for the kernels' bf16 operands that
# every bound uses, and float32 flop/s outside the tensor cores, where the
# kernels do their math today (printed beside the K3/K4 bound)
H100_SXM = "H100 80GB HBM3"
HBM_PEAK, BF16_TC_PEAK, FP32_PEAK = 3.35e12, 989e12, 67e12


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
    """One nvcc per source, all started together."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(PA.SOURCES)) as pool:
        paths = list(pool.map(_build.build, PA.SOURCES))
    for source in PA.SOURCES:
        PA._lib(source)
    secs = time.perf_counter() - t0
    for source, path in zip(PA.SOURCES, paths):
        info = _build.BUILD_INFO[source]
        ptxas = " | ".join(line.strip() for line in
                           str(info["ptxas"]).splitlines()
                           if "registers" in line or "spill" in line)
        print(f"[build] {path.name}: nvcc {info['seconds']:.2f} s; "
              f"ptxas: {ptxas}")
    print(f"[build] {len(paths)} sources in {secs:.2f} s")
    return secs


def engine_distance(kv_features=2 * L * KV * HD, gqa_group=H // KV):
    """The preload distance the engine binds at full width (planner d* on
    the port's default tiers, clamped to the FIFO as the engine does); by
    default at qwen3-1.7b's packed page."""
    plan = plan_kv_page_stream(page_tokens=P, kv_features=kv_features,
                               tier=H100_PINNED_HOST, pe=H100_SM,
                               gqa_group=gqa_group)
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
    once and each output written once over the HBM peak, against the flops
    of the visible positions over the bf16 peak (the operands' type)."""
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
    t_ops = 4.0 * H * HD * toks / BF16_TC_PEAK * 1e3
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


# ---------------------------------------------------------------------- #
def _mla_case(gen, dev, lengths):
    B = len(lengths)
    n_pages = MAX_SEQ // P
    NF = B * n_pages + 4
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev,
                                     dtype=torch.bfloat16)
    perm = torch.randperm(NF - 2, generator=gen, device=dev)[:B * n_pages] + 2
    pt = perm.reshape(B, n_pages).to(torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    frames = pt.gather(1, (lens // P).long()[:, None])[:, 0].contiguous()
    frames[lens == 0] = 1                    # an idle slot writes the TRASH frame
    return dict(qa=rnd(B, MLA_H, KVR), qr=rnd(B, MLA_H, DR),
                cp=rnd(MLA_LAYERS, NF, P, KVR), rp=rnd(MLA_LAYERS, NF, P, DR),
                cn=rnd(B, KVR), rn=rnd(B, DR), pt=pt, lens=lens,
                frames=frames, offs=(lens % P).to(torch.int32))


def _mla_bound(c, commit):
    """Least time for K3 (commit) or K4 on this card: bytes each input read
    once and each output written once (visible page slabs once, though the
    kernel reads each H / Hb times) over the HBM peak, against the flops of
    the visible positions and the current token, 2 * (2 kvr + dr) per token
    and head, over the bf16 peak (the operands' type). Also returns the time
    of the same flops on the fp32 CUDA cores, where the kernel does them."""
    lens = c["lens"].tolist()
    pages = sum(-(-n // P) for n in lens)
    nbytes = pages * P * (KVR + DR) * 2
    inputs = ["qa", "qr", "cn", "rn", "pt", "lens"]
    if commit:
        inputs += ["frames", "offs", "cn", "rn"]     # the committed rows
    nbytes += sum(c[k].numel() * c[k].element_size() for k in inputs)
    nbytes += c["qa"].numel() * 2                       # out
    flops = sum(n + 1 for n in lens) * MLA_H * 2 * (2 * KVR + DR)
    t_bytes = nbytes / HBM_PEAK * 1e3
    t_ops = flops / BF16_TC_PEAK * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            nbytes, flops, flops / FP32_PEAK * 1e3)


def _mla_planted_faults(c, want, layer, scale):
    """Wrong answers the limit must reject, on the mixed case: the last
    visible page of the length-1000 row skipped, and the current token not
    folded in."""
    row = c["lens"].tolist().index(1000)
    cut = c["lens"].clone()
    cut[row] = 1000 // P * P
    args = (c["qa"], c["qr"], c["cp"][layer], c["rp"][layer], c["pt"])
    faults = {
        "last page of the length-1000 row skipped":
            PA.paged_mla_decode_attention_ref(*args, cut, c["cn"], c["rn"],
                                              scale=scale),
        "current token not folded":
            PA.paged_mla_decode_attention_ref(*args, c["lens"], None, None,
                                              scale=scale),
    }
    for what, bad in faults.items():
        if _close(bad, want):
            raise AssertionError(f"the bf16 limit lets a planted fault through: "
                                 f"{what}")
    print(f"[kernels-mla] planted faults rejected by the limit: "
          f"{', '.join(faults)}")


def phase_kernels_mla():
    """K3/K4 against their plain versions at deepseek-v2 widths."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    d_eng = engine_distance(MLA_LAYERS * (KVR + DR), 1)
    scale = 1.0 / math.sqrt(MLA_QK)
    cases = [("mixed", [0, 7, 16, 1000, 513, 250, 64, 999]),
             ("other", [5, 300, 16, 777, 0, 1023, 48, 129])]
    results = {"k3": [], "k4": []}
    layer = 4
    for label, lengths in cases:
        c = _mla_case(gen, dev, lengths)
        ring = [PULConfig(distance=d) for d in sorted({1, d_eng})]
        ring.append(PULConfig(distance=d_eng, strategy=IssueStrategy.SEQUENTIAL))
        for cfg in ring:
            plan = PA.mla_ring_plan(cfg, H=MLA_H, P=P, kvr=KVR, dr=DR)
            d = (f"{cfg.distance}{'' if cfg.strategy is IssueStrategy.BATCH else ' seq'}"
                 f" (ring: d={plan.distance}, {plan.slots} slots)")
            rest = (c["pt"], c["lens"], c["cn"], c["rn"])
            # K4 first (it reads the pre-commit planes), then K3
            out4 = PA.pul_paged_mla_decode_attention(
                c["qa"], c["qr"], c["cp"][layer], c["rp"][layer], *rest,
                scale=scale, cfg=cfg)
            cp0, rp0 = c["cp"].clone(), c["rp"].clone()
            out3 = PA.pul_paged_sweep_mla_decode_attention(
                c["qa"], c["qr"], c["cp"], c["rp"], layer, *rest, c["frames"],
                c["offs"], scale=scale, cfg=cfg)
            torch.cuda.synchronize()
            want = PA.paged_sweep_mla_decode_attention_ref(
                c["qa"], c["qr"], cp0, rp0, layer, *rest, c["frames"],
                c["offs"], scale=scale)
            err3 = (out3.float() - want.float()).abs().max().item()
            err4 = (out4.float() - want.float()).abs().max().item()
            _check(out3, want, f"{label} d={d}: K3")
            _check(out4, want, f"{label} d={d}: K4")
            if not torch.equal(out3, out4):
                raise AssertionError(f"{label} d={d}: K3 out != K4 out bitwise")
            if not (torch.equal(c["cp"], cp0) and torch.equal(c["rp"], rp0)):
                raise AssertionError(f"{label} d={d}: K3 commit differs from "
                                     "the plain version's")
            if label == "mixed" and cfg is ring[0]:
                _mla_planted_faults(dict(c, cp=cp0, rp=rp0), want, layer, scale)
            del cp0, rp0
            results["k3"].append(err3)
            results["k4"].append(err4)
            print(f"[kernels-mla] {label} d={d}: max|K3-plain| {err3:.3e} "
                  f"max|K4-plain| {err4:.3e} (limit: two bf16 ulps of each "
                  "row's largest value) K3==K4 bitwise")
        del c
    # timing at the mixed case's shapes with the engine distance
    c = _mla_case(gen, dev, cases[0][1])
    cfg = PULConfig(distance=d_eng)
    rest = (c["pt"], c["lens"], c["cn"], c["rn"])
    args3 = (c["qa"], c["qr"], c["cp"], c["rp"], 2, *rest, c["frames"],
             c["offs"])
    args4 = (c["qa"], c["qr"], c["cp"][2], c["rp"][2], *rest)
    k3_ms = _time_ms(lambda: PA.pul_paged_sweep_mla_decode_attention(
        *args3, scale=scale, cfg=cfg))
    k4_ms = _time_ms(lambda: PA.pul_paged_mla_decode_attention(
        *args4, scale=scale, cfg=cfg))
    plain3_ms = _time_ms(lambda: PA.paged_sweep_mla_decode_attention_ref(
        *args3, scale=scale), reps=10)
    plain4_ms = _time_ms(lambda: PA.paged_mla_decode_attention_ref(
        *args4, scale=scale), reps=10)
    # load balance: with about one block per SM, a time near the mixed case's
    # with every row at the longest length means the longest row sets it
    f = _mla_case(gen, dev, [1000] * len(cases[0][1]))
    full_ms = _time_ms(lambda: PA.pul_paged_mla_decode_attention(
        f["qa"], f["qr"], f["cp"][2], f["rp"][2], f["pt"], f["lens"], f["cn"],
        f["rn"], scale=scale, cfg=cfg))
    del f
    print(f"[kernels-mla] K4 with every row at length 1000: {full_ms:.4f} ms "
          f"(mixed case: {k4_ms:.4f} ms)")
    out = {}
    for key, ms, plain_ms, commit in (("k3", k3_ms, plain3_ms, True),
                                      ("k4", k4_ms, plain4_ms, False)):
        bound_ms, bound_by, nbytes, flops, fp32_ms = _mla_bound(c, commit)
        print(f"[kernels-mla] B=8 lengths {c['lens'].tolist()} d={d_eng}: "
              f"{key.upper()} {ms:.4f} ms; plain {plain_ms:.4f} ms; bound "
              f"{bound_ms:.5f} ms ({bound_by}: {nbytes} B, {flops} flops at "
              f"the bf16 peak); the same flops on the fp32 CUDA cores "
              f"{fp32_ms:.5f} ms")
        out[key] = dict(max_abs_err=max(results[key]), ms=ms,
                        plain_ms=plain_ms, bound_ms=bound_ms,
                        bound_by=bound_by)
    return out


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
    """Serve the request script through the sweep kernel (K1; K3 for MLA)
    or the per-layer one (K2; K4), with one preempt/resume mid-stream."""
    pair = ("k3", "k4") if cfg.attn_type == "mla" else ("k1", "k2")
    key = pair[0] if sweep else pair[1]
    tag = "[serving-mla]" if cfg.attn_type == "mla" else "[serving]"
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
    others = [k for k, n in launches.items() if n and k != key]
    if others:
        raise AssertionError(f"{others} launched on the {key} path")
    if pm.page_faults < 1 or pm.shared_hits < 1:
        raise AssertionError(f"page_faults {pm.page_faults}, shared_hits "
                             f"{pm.shared_hits}: the cold tier or prefix "
                             "sharing did not run")
    stats = {"model": cfg.name, "layers": layers,
             "path": f"{'sweep' if sweep else 'per-layer'} ({key.upper()})",
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
    print(f"{tag} " + json.dumps(stats))
    del eng
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return out, stats


def smoke_config(arch):
    """The smoke's configuration of `arch`: full width; deepseek-v2's depth
    cut to MLA_LAYERS (the dense layer 0 and 5 MoE layers)."""
    cfg = get_config(arch)
    if arch == DEEPSEEK:
        cfg = dataclasses.replace(cfg, num_layers=MLA_LAYERS)
    return cfg


def profile_decode(arch="qwen3-1.7b"):
    """One-off, not a phase of the smoke: where a decode tick's time goes.
    torch.profiler over 4 pure decode ticks of the sweep path at the smoke
    configuration of `arch` (8 requests, all admitted at tick 0). Prints
    one [profile] line."""
    from torch.profiler import ProfilerActivity, profile
    cfg = smoke_config(arch)
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
    stats = {"smi": _smi("name,power.limit"), "model": cfg.name,
             "layers": cfg.num_layers, "ticks": ticks,
             "wall_ms_per_tick": wall * 1e3 / ticks,
             "device_busy_ms_per_tick": busy / ticks,
             "device_idle_share": 1.0 - busy / (wall * 1e3),
             "kernels_per_tick": len(kernels) / ticks,
             "top_level_aten_ops_per_tick": ops / ticks,
             "top_kernels_ms_per_tick": [(n[:60], ms / ticks) for n, ms in top]}
    print("[profile] " + json.dumps(stats))
    return stats


def _serve_both_paths(cfg, params):
    """The request script through the sweep and then the per-layer kernel
    path; their token streams must be bitwise equal."""
    warm_up(cfg, params)
    out1, s1 = phase_serving(cfg, params, sweep=True)
    out2, s2 = phase_serving(cfg, params, sweep=False)
    tag = "[serving-mla]" if cfg.attn_type == "mla" else "[serving]"
    if out1 != out2:
        raise AssertionError(f"{cfg.name}: per-layer ({s2['path']}) tokens "
                             f"differ from the sweep ({s1['path']}) tokens")
    if s1["bytes_hot_written"] != s2["bytes_hot_written"]:
        raise AssertionError(f"{cfg.name}: bytes_hot_written differs between "
                             "the paths")
    print(f"{tag} {s2['path']} tokens == {s1['path']} tokens bitwise over "
          f"{sum(len(v) for v in out1.values())} tokens")
    return s1, s2


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
    kern.update(phase_kernels_mla())
    print(f"[done] kernels {time.perf_counter() - t0:.1f} s")

    cfg = smoke_config("qwen3-1.7b")
    params = init_params(cfg, seed=0, device="cuda")
    stats = dict(zip(("k1", "k2"), _serve_both_paths(cfg, params)))
    del params                     # free qwen3 before deepseek's ~43 GB
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[done] serving {time.perf_counter() - t0:.1f} s")

    cfg = smoke_config(DEEPSEEK)
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    weights = sum(t.numel() * t.element_size() for _, t in flatten(params))
    print(f"[serving-mla] {cfg.name}: {cfg.num_layers} of 60 layers (dense "
          f"layer 0 + {cfg.num_groups} MoE), {weights / 1e9:.2f} GB of "
          f"weights, init {time.perf_counter() - t1:.1f} s; peak allocated "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    stats.update(zip(("k3", "k4"), _serve_both_paths(cfg, params)))
    print(f"[serving-mla] peak allocated "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del params
    print(f"[done] {time.perf_counter() - t0:.1f} s")

    rows = []
    for key, name, source, line in (
            ("k1", "pul_paged_sweep_decode_attention", "pul_paged_decode", 406),
            ("k2", "pul_paged_decode_attention", "pul_paged_decode", 152),
            ("k3", "pul_paged_sweep_mla_decode_attention",
             "pul_paged_mla_decode", 553),
            ("k4", "pul_paged_mla_decode_attention", "pul_paged_mla_decode",
             272)):
        rows.append({"name": name, "route": "cuda",
                     "source": f"src/repro_torch/csrc/{source}.cu",
                     "replaces": f"src/repro/kernels/pul_attention.py:{line}",
                     "launches": stats[key]["launches"],
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
