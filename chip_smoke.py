"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100 (SXM).

    python3 chip_smoke.py

Phases, one line each; every phase runs, and any failure propagates so the
exit code is not 0:

  1. device       -- card name and power limit (nvidia-smi), copy rates that
                     feed the H100 tiers of ``repro_torch.core.pul``
  2. build        -- compile the CUDA sources of ``src/repro_torch/csrc``, one
                     nvcc each, all started together
  3. kernels      -- K1/K2 (split-KV: a split and a merge kernel per call)
                     against their plain PyTorch versions at qwen3-1.7b
                     widths (bf16, two bf16 ulps of each row's largest value),
                     the split plan, planted faults that the limit must
                     reject (one split left out of the merge among them),
                     times at the plan's split count and at forced ones,
                     bounds and plain times
  4. kernels-mla  -- the same for K3/K4 (split-KV, the products on the
                     tensor cores) at deepseek-v2 widths, with the fp32
                     workspace's bytes beside the pages'
  5. kernels-gather -- the PUL gather K5 (1D bulk copies) against its plain
                     version, bitwise, at the qwen3 and deepseek serving page
                     geometries (with planted faults) and in three types at
                     three distances; the bulk plan (chunk, d, slots), times,
                     byte bounds, plain and index_select times
  6. kernels-micro -- the paper's microbenchmark kernels against their plain
                     versions: K8 (SUM) and K9 (filter) on a 4 GiB table of
                     2^26 64-byte rows, K8 exactly equal to the fp64 sum (the
                     values make every order exact), K9 bitwise in both modes
                     and at both unload distances, on that f32 table and on
                     its values as a 2 GiB bf16 table, with the bit-vector's
                     TMA tile plan and materialize's time and bound; K10 at
                     4096^3 bf16 -> f32, 2048^3 f32 and 4096^3 bf16 -> bf16
                     through ops.matmul_op, within 2 sqrt(K) 2^-24 (|A||B|) (plus
                     one bf16 rounding for the bf16 output), both bf16 cases
                     on the wgmma body (its own launch count); a planted fault
                     each; times, bounds, plain times, torch.matmul for K10
  7. paper        -- run_all on the card: the DMA twin's Exps. 1-5 and the
                     functional sweep through K8 and K9, all 11 claims PASS;
                     then K8 timed over d in {1, ..., 32} x both issue orders
                     and rows_per_req in {1, 16, 128} at the same bytes, and
                     K9 in each mode at unload_distance 0 and 1
  8. kernels-attn -- the dense attention pair: K7 through ops.attention_op
                     (qwen3 prefill at T = S = 4096, a chunk of 512 over
                     4096, gemma2-27b widths with softcap 50 and window
                     4096, f32 at 1024, qwen2.5-32b's group of 5 and
                     gemma3-12b's hd 256 with window 1024, both at
                     T = S = 4096) and K6 over a dense qwen3 cache of
                     32768 at 8 lengths (split-KV: its plan, blocks an SM and
                     segments, and every row at 32768 too); launches counted
                     on that path, every
                     bf16 case on the tensor-core body (its own count); each
                     against its plain version (bf16 two ulps of the row's
                     largest value, f32 3e-4) at d in {1, 4} in both issue
                     orders; planted faults (for K6 also one segment's piece
                     left out of the merge); times, bounds, plain times and
                     scaled_dot_product_attention's times
  9. serving      -- full-width qwen3-1.7b (random weights from seed 0) served
                     by the paged engine through K1 (fused sweep), then the
                     same script through K2 (per layer), each decode step
                     replayed from its captured CUDA graph, then both paths
                     again with the step run eagerly: all four token streams
                     bitwise equal; decode tick medians and tokens/s,
                     captured beside eager
 10. serving-assembly -- the same model and script on the assembly path,
                     through K5 and then through plain indexing: bitwise-equal
                     tokens; one decode step's logits against K1's; the
                     stream agrees with K1's up to the first bf16 near-tie
 11. serving-dense -- the same model and requests on the dense ServingEngine
     serving-bench -- the port's serving benchmarks on the same params
                     (``repro_torch.benchmarks``): serving_slo's three
                     policies on the captured sweep K1 (contract and gate
                     against the port's full-width baseline; ticks, TTFT
                     p50/p99 in ticks, tokens/s and tick medians per
                     policy), roofline --serving (gated; each tier's
                     fraction), paged_decode (assembly through K5 and K1
                     eager, K1 captured: tokens agree up to the first bf16
                     near-tie, captured == eager bitwise), the slo-edf run
                     with shadow_check six times in turns with six
                     unchecked runs (no violation; decode tick medians side
                     by side, with their spread and whether the two sides
                     separate) and one planted corruption of a checked
                     engine's trace, which must raise
                     LifecycleViolationError
 12. serving-long -- the streamed prefill attention against the dense one at
                     T = S = 4096 (qwen3 widths, within 2e-2 x max |out|);
                     then prompts of 2100, 3000, 4000 and 500 tokens on 4
                     slots of 4096 (buckets up to 4096), 16 new tokens each,
                     through K1 and K2 (captured): bitwise-equal tokens, every
                     request finished, finite logits; monolithic prefill,
                     then 1024-token chunked prefill
 13. profile      -- the captured K1 step's device span and busy share, with
                     and without torch.profiler (``profile_decode``)
 14. serving-mla  -- full-width deepseek-v2-236b, depth cut to 6 layers (the
                     dense layer 0 and 5 MoE layers), the same script through
                     K3 and then K4, captured and eager: bitwise-equal tokens
 15. serving-mla-assembly -- deepseek on the assembly path (K5 at F = 3,456),
                     as in phase 10, one decode step against K3's
 16. serving-mla-long, profile -- phases 12 (without the attention check)
                     and 13 for deepseek through K3/K4
 17. serving-qwen2.5, serving-gemma2, serving-gemma3 -- full-width
                     qwen2.5-32b, gemma2-27b and gemma3-12b at full depth,
                     random weights from seed 0, one at a time, each freed
                     before the next: phase 9's script captured on K1 and
                     K2, then eager on K1 (three streams bitwise equal,
                     K1/K2 launches one per layer and decode step under
                     replay), once on the assembly path through K5, and one
                     decode step of the assembly path and of the dense
                     ServingEngine within 2e-2 x max |logits| of K1's on one
                     state (8 prompts of 512 tokens); then the profile of
                     the captured K1 step (phase 13)
 18. serving-gemma3-long -- phase 12's long script on gemma3-12b (every
                     decode position past its window of 1024), sweep ==
                     per-layer bitwise, and the same-state step at 2048
                     tokens (the dense engine on rings of 1024 rows)
 19. serving-gemma2-window -- first (before gemma2's weights load) the
                     streamed prefill attention with window 4096 and
                     softcap 50 at gemma2 widths, T = S = 6144, within 2e-2
                     x max |out| of the dense one; then 2 slots of 6144,
                     prompts of 5000, 4500 and 300 tokens (decode positions
                     to 5015, past the window), monolithic and chunked,
                     sweep == per-layer bitwise, the same-state step at
                     5000 tokens
 20. serving-grok, serving-internvl2, serving-musicgen -- phase 17 for the
                     rest of the attention zoo, random weights from seed
                     0, one at a time: grok-1-314b (MoE through the einsum
                     dispatch, a group of 6, softcap 30) with its depth cut
                     64 -> 6 layers (60.7 GB of weights), internvl2-2b
                     (vocab 92,553) and musicgen-large (MHA at hd 64,
                     sinusoidal positions, the plain GELU MLP) at full
                     width and depth
     (kernels-served, after phase 3: K1/K2 at the widths and windows of
     qwen2.5-32b, gemma2-27b, gemma3-12b, grok-1 and musicgen against the
     plain version, at the plan's split count and at 128 splits, with
     times and byte bounds; kernels-gather holds K5 at every served model's
     page width; every phase of 17-20 prints its seconds and peak allocated
     memory)
 21. summary      -- one JSON line listing the kernels, with the body each
                     ran (wgmma, mma.sync, split-kv, split-kv mma.sync,
                     cp.async.bulk, cp.async.bulk.tensor or fma)
 22. last line: {"ok": true, "device": {...}}

Where a decode tick's time goes on another path (device busy share, top
kernels) is a one-off measurement:

    python3 -c "import chip_smoke; chip_smoke.profile_decode(path='sweep-eager')"
    python3 -c "import chip_smoke; chip_smoke.profile_decode('deepseek-v2-236b', 'sweep-eager')"
    python3 -c "import chip_smoke; chip_smoke.profile_decode(path='assembly')"

and so is the microbenchmarks' sweep with extra ring slots, which cap the
blocks each SM holds, where the paper's distance and unload order show on
real copies:

    python3 -c "import chip_smoke; chip_smoke.slots_sweep()"

and K5's chunk sizes beside index_select, and K1 (and K3) at forced split
counts and distances with their two kernels' device times:

    python3 -c "import chip_smoke; chip_smoke.chunk_sweep()"
    python3 -c "import chip_smoke; chip_smoke.split_sweep()"
    python3 -c "import chip_smoke; chip_smoke.mla_split_sweep()"

and K6 at forced segment sizes and distances with its two kernels' device
times, and the probe of how many bytes the card fetches for a short read of
a row (K9's bound):

    python3 -c "import chip_smoke; chip_smoke.decode_sweep()"
    python3 -c "import chip_smoke; chip_smoke.sector_probe()"

Imports only torch, numpy and ``repro_torch`` (from ``src/`` beside this
file); exits non-zero without CUDA.
"""
from __future__ import annotations

import ctypes
import dataclasses
import gc
import importlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple, Tuple

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

from repro_torch.benchmarks import common, paged_decode  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import IssueStrategy, PULConfig  # noqa: E402
from repro_torch.core.planner import plan_kv_page_stream  # noqa: E402
from repro_torch.core.pul import H100_PINNED_HOST, H100_SM  # noqa: E402
from repro_torch.kernels import SOURCES, _build, ops  # noqa: E402
from repro_torch.kernels.pul_decode import (  # noqa: E402
    DECODE_BODY, decode_attention_kernel_ref, decode_attention_split_ref,
    decode_pieces, decode_ring_plan, pul_decode_attention)
from repro_torch.kernels._runtime import _blocks_per_sm  # noqa: E402
from repro_torch.kernels.pul_filter import (  # noqa: E402
    filter_materialize_ref, filter_ref, filter_ring_plan, pul_filter)
from repro_torch.kernels.pul_gather import (  # noqa: E402
    BODY as GATHER_BODY, gather_bulk_plan, gather_ref, page_gather_ref,
    pul_gather, pul_page_gather)
from repro_torch.kernels.pul_matmul import (  # noqa: E402
    matmul_body, matmul_ref, matmul_ring_plan, matmul_tc_plan)
from repro_torch.kernels.pul_sum import pul_sum, sum_ref, sum_ring_plan  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.models.module import flatten  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    EngineConfig, PackedKVLayout, PagedEngineConfig, PagedServingEngine,
    Request, ServingEngine)

# the module: the package exports the function pul_attention under its name
PA = importlib.import_module("repro_torch.kernels.pul_attention")

# qwen3-1.7b widths and the serving geometry of the serving phases
H, KV, HD, P, L = 16, 8, 128, 16, 28
SLOTS, MAX_SEQ, SERVE_BUCKETS = 8, 1024, (128, 256, 512)
#: serving-bench: the shadow-checked slo-edf run and the unchecked one, in
#: turns, this many of each
SHADOW_TURNS = 6
# deepseek-v2-236b widths (MLA: 128 heads, kv_lora 512, rope 64, qk 128 + 64)
# and the smoke's one cut, depth: the dense layer 0 and 5 MoE layers
DEEPSEEK = "deepseek-v2-236b"
MLA_H, KVR, DR, MLA_QK = 128, 512, 64, 128 + 64
MLA_LAYERS = 6
# grok-1-314b's one cut, depth 64 -> 6 layers: 59.0 GB of layers and the
# 1.61 GB tied embedding, so its weights and the init's fp32 draw of one
# layer's experts (6.4 GB) fit one card
GROK = "grok-1-314b"
GROK_LAYERS = 6
# published peaks of the H100 SXM (NVIDIA data sheet, 700 W): HBM bytes/s,
# dense bf16 tensor-core flop/s, the peak for the kernels' bf16 operands that
# every bound uses, and float32 flop/s outside the tensor cores, where the
# first K3/K4 design did its math (printed beside the K3/K4 bound)
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
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        paths = list(pool.map(_build.build, SOURCES))
    for source in SOURCES:
        _build.load(source)
    secs = time.perf_counter() - t0
    for source, path in zip(SOURCES, paths):
        info = _build.BUILD_INFO[source]
        kernels = _ptxas_kernels(str(info["ptxas"]))
        regs = ", ".join(f"{k} {r}" for k, r, _ in kernels)
        spills = [f"{k} {sp} B" for k, _, sp in kernels if sp]
        print(f"[build] {path.name}: nvcc {info['seconds']:.2f} s; "
              f"registers: {regs}; spill stores: "
              f"{', '.join(spills) or 'none'}")
    print(f"[build] {len(paths)} sources in {secs:.2f} s")
    return secs


def _kernel_label(mangled):
    """A readable name of a mangled kernel: name<type, ints> (the name is
    the length-prefixed identifier that ends in 'kernel')."""
    for i in range(len(mangled)):
        m = re.match(r"\d+", mangled[i:])
        if not m:
            continue
        end = i + m.end()
        name = mangled[end:end + int(m.group())]
        if name.endswith("kernel"):
            rest = mangled[end + len(name):]
            args = (["f32"] if rest.startswith("If") else
                    ["bf16"] if rest.startswith("I13__nv_bfloat16") else [])
            args += re.findall(r"Li(\d+)E", rest)
            return f"{name}<{','.join(args)}>" if args else name
    return mangled


def _ptxas_kernels(ptxas):
    """(kernel, registers, spill-store bytes) of each entry function in
    ptxas's -v report."""
    out, name, spill = [], None, 0
    for line in ptxas.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, spill = _kernel_label(m.group(1)), 0
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append((name, int(m.group(1)), spill))
            name = None
    return out


def engine_distance(kv_features=2 * L * KV * HD, gqa_group=H // KV):
    """The preload distance the engine binds at full width (planner d* on
    the port's default tiers, clamped to the FIFO as the engine does); by
    default at qwen3-1.7b's packed page."""
    plan = plan_kv_page_stream(page_tokens=P, kv_features=kv_features,
                               tier=H100_PINNED_HOST, pe=H100_SM,
                               gqa_group=gqa_group)
    return max(1, min(plan.cfg.distance, plan.cfg.fifo_depth))


def _kernel_case(gen, dev, lengths, *, softcap=None, window=None, heads=H,
                 kv=KV, hd=HD, layers=L, max_seq=MAX_SEQ):
    """K1/K2 inputs: B = len(lengths) slots of max_seq tokens on P-token
    pages in random frames of `layers`-deep planes; qwen3-1.7b's widths
    unless given."""
    B = len(lengths)
    n_pages = max_seq // P
    NF = B * n_pages + 4
    planes_k = torch.randn((layers, NF, kv, P, hd), generator=gen, device=dev,
                           dtype=torch.bfloat16)
    planes_v = torch.randn((layers, NF, kv, P, hd), generator=gen, device=dev,
                           dtype=torch.bfloat16)
    perm = torch.randperm(NF - 2, generator=gen, device=dev)[:B * n_pages] + 2
    pt = perm.reshape(B, n_pages).to(torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    q = torch.randn((B, heads, hd), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    kn = torch.randn((B, kv, hd), generator=gen, device=dev, dtype=torch.bfloat16)
    vn = torch.randn((B, kv, hd), generator=gen, device=dev, dtype=torch.bfloat16)
    frames = pt.gather(1, (lens // P).long()[:, None])[:, 0].contiguous()
    frames[lens == 0] = 1                    # an idle slot writes the TRASH frame
    offs = (lens % P).to(torch.int32)
    return dict(q=q, kp=planes_k, vp=planes_v, pt=pt, lens=lens, kn=kn, vn=vn,
                frames=frames, offs=offs, softcap=softcap, window=window)


def _bound(c):
    """Least time for the kernel's work on this card: bytes each input read
    once and each output written once over the HBM peak, against the flops
    of the visible positions over the bf16 peak (the operands' type). A
    windowed row counts only its pages inside the window."""
    lens = c["lens"].tolist()
    w = c["window"]
    _, heads, hd = c["q"].shape
    kv = c["kp"].shape[2]
    toks = 0
    slab_bytes = 0
    for n in lens:
        lo = max(0, n - w + 1) // P if w else 0
        pages = max(0, -(-n // P) - lo)
        slab_bytes += pages * P * hd * 2 * 2 * kv          # K and V, per kv head
        toks += (n - (max(0, n - w + 1) if w else 0)) + 1
    small = sum(t.numel() * t.element_size() for t in
                (c["q"], c["kn"], c["vn"], c["pt"], c["lens"]))
    small += c["q"].numel() * 2                             # out
    nbytes = slab_bytes + small
    t_bytes = nbytes / HBM_PEAK * 1e3
    t_ops = 4.0 * heads * hd * toks / BF16_TC_PEAK * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            nbytes)


def _planted_faults(c, want, layer, kw, n_split):
    """Wrong answers the limit must reject, on the mixed case: the last
    visible page of the length-1000 row skipped, the current token not
    folded in, and the merge with one split (of the n_split the plan gave)
    left out."""
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
        f"split {n_split // 2} of {n_split} left out of the merge":
            PA.paged_decode_split_ref(
                c["q"], c["kp"][layer], c["vp"][layer], c["pt"], c["lens"],
                n_split=n_split, k_new=c["kn"], v_new=c["vn"],
                drop_split=n_split // 2, **kw),
    }
    for what, bad in faults.items():
        if _close(bad, want):
            raise AssertionError(f"the bf16 limit lets a planted fault through: "
                                 f"{what}")
    print(f"[kernels] planted faults rejected by the limit: {', '.join(faults)}")


def _split_plan(c, cfg):
    """The split plan K1/K2 launch with on this card for case c."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return PA.split_plan_for(cfg, c["q"].shape, c["kp"].shape,
                             c["pt"].shape[1], sms)


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
                _planted_faults(dict(c, kp=kp0, vp=vp0), want, layer, kw,
                                _split_plan(c, cfg).n_split)
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
    plan = _split_plan(c, cfg)
    print(f"[kernels] B=8 lengths {c['lens'].tolist()} d={d_eng}: K1 {k1_ms:.4f} ms"
          f" K2 {k2_ms:.4f} ms; plain {plain1_ms:.4f} / {plain2_ms:.4f} ms; "
          f"bound {bound_ms:.5f} ms ({bound_by}, {nbytes} B); split plan: "
          f"{plan.n_split} splits of <= {plan.pages_per_split} pages, ring "
          f"d={plan.distance}, {plan.slots} slots, {plan.smem_bytes} B a block"
          f" (grid {plan.n_split} x {KV} x 8)")
    forced = {n: _time_ms(lambda: PA.pul_paged_sweep_decode_attention(
        c["q"], c["kp"], c["vp"], layer, c["pt"], c["lens"], c["kn"], c["vn"],
        c["frames"], c["offs"], cfg=cfg, n_split=n, **kw))
        for n in (1, 2, 4, 8, 16, 32, 64)}
    print("[kernels] K1 ms by forced split count: " + ", ".join(
        f"{n}: {ms:.4f}" for n, ms in forced.items()))
    return {
        "k1": dict(max_abs_err=max(results["k1"]), ms=k1_ms, plain_ms=plain1_ms,
                   bound_ms=bound_ms, bound_by=bound_by, body=PA.PAGED_BODY),
        "k2": dict(max_abs_err=max(results["k2"]), ms=k2_ms, plain_ms=plain2_ms,
                   bound_ms=bound_ms, bound_by=bound_by, body=PA.PAGED_BODY),
    }


#: K1/K2 at the served models' widths (SERVED_MODELS) where they differ
#: from qwen3-1.7b's, full width: slot lengths before, at and past the
#: window (and where its first position starts a page), on slots of the
#: model's longest phase
SERVED_K12 = {
    "qwen2.5-32b": [0, 7, 16, 1000, 513, 250, 64, 999],
    "gemma2-27b": [300, 4095, 4096, 4111, 5015, 6143],
    "gemma3-12b": [500, 1023, 1024, 1039, 2100, 4095],
    GROK: [0, 7, 16, 1000, 513, 250, 64, 999],
    "musicgen-large": [1, 15, 16, 17, 1000, 500, 128, 1023],
}


def _attention_widths(cfg):
    """K1/K2's widths at `cfg`'s full width (heads, kv heads, head dim) and
    its options (softcap and window, where the model has them)."""
    opts = {k: v for k, v in (("softcap", cfg.attn_softcap),
                              ("window", cfg.sliding_window)) if v}
    return dict(heads=cfg.num_heads, kv=cfg.num_kv_heads,
                hd=cfg.head_dim), opts


def phase_kernels_served():
    """K1 and K2 at qwen2.5-32b's group of 5, gemma2-27b's softcap 50 and
    window 4096, gemma3-12b's hd 256 and window 1024, grok-1's group of 6
    with softcap 30 and musicgen's group of 1 at hd 64 (SERVED_K12):
    within two bf16 ulps of the plain version at the plan's split count and
    at 128 splits (where a windowed row's visible pages leave splits that
    see none), K1 == K2 bitwise, the commit bitwise; times at the engine's
    distance beside the plain version's and the byte bound, which counts
    only the pages inside the window. Returns the rows by model."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    out = {}
    for model, lengths in SERVED_K12.items():
        widths, opts = _attention_widths(get_config(model))
        past = SERVED_MODELS[model]
        widths["max_seq"] = past.geometry[1] if past else MAX_SEQ
        c = _kernel_case(gen, dev, lengths, layers=4, **widths, **opts)
        hd = widths["hd"]
        cfg = PULConfig(distance=engine_distance(
            2 * smoke_config(model).num_layers * widths["kv"] * hd,
            widths["heads"] // widths["kv"]))
        kw = dict(scale=1.0 / math.sqrt(hd), softcap=c["softcap"],
                  window=c["window"])
        layer = 3
        kp0, vp0 = c["kp"].clone(), c["vp"].clone()   # the plain commit's
        want = PA.paged_sweep_decode_attention_ref(
            c["q"], kp0, vp0, layer, c["pt"], c["lens"], c["kn"], c["vn"],
            c["frames"], c["offs"], **kw)
        errs = []
        for n_split in (None, 128):
            kp, vp = c["kp"].clone(), c["vp"].clone()
            out2 = PA.pul_paged_decode_attention(
                c["q"], kp[layer], vp[layer], c["pt"], c["lens"], cfg=cfg,
                k_new=c["kn"], v_new=c["vn"], n_split=n_split, **kw)
            out1 = PA.pul_paged_sweep_decode_attention(
                c["q"], kp, vp, layer, c["pt"], c["lens"], c["kn"], c["vn"],
                c["frames"], c["offs"], cfg=cfg, n_split=n_split, **kw)
            torch.cuda.synchronize()
            what = f"{model} n_split={n_split or 'plan'}"
            _check(out1, want, f"{what}: K1")
            _check(out2, want, f"{what}: K2")
            if not torch.equal(out1, out2):
                raise AssertionError(f"{what}: K1 out != K2 out bitwise")
            if not (torch.equal(kp, kp0) and torch.equal(vp, vp0)):
                raise AssertionError(f"{what}: K1 commit differs from the "
                                     "plain version's")
            errs.append((out1.float() - want.float()).abs().max().item())
            del kp, vp
        args = (c["q"], c["kp"], c["vp"], layer, c["pt"], c["lens"], c["kn"],
                c["vn"], c["frames"], c["offs"])
        k1_ms = _time_ms(lambda: PA.pul_paged_sweep_decode_attention(
            *args, cfg=cfg, **kw))
        k2_ms = _time_ms(lambda: PA.pul_paged_decode_attention(
            c["q"], c["kp"][layer], c["vp"][layer], c["pt"], c["lens"],
            cfg=cfg, k_new=c["kn"], v_new=c["vn"], **kw))
        plain_ms = _time_ms(lambda: PA.paged_sweep_decode_attention_ref(
            *args, **kw), reps=5, warmup=1)
        bound_ms, bound_by, nbytes = _bound(c)
        plan = _split_plan(c, cfg)
        row = {"model": model, "B": len(lengths), "lengths": lengths,
               "heads": widths["heads"], "kv": widths["kv"], "hd": hd,
               **opts, "max_abs_err": max(errs), "k1_ms": k1_ms,
               "k2_ms": k2_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "bytes": nbytes,
               "k1_over_bound": k1_ms / bound_ms, "n_split": plan.n_split,
               "distance": plan.distance}
        print("[kernels-served] " + json.dumps(row))
        out[model] = row
        del c, kp0, vp0, want
        torch.cuda.empty_cache()
    return out


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
    split kernel reads each ceil(H / 64) times, twice at 128 heads, and its
    fp32 workspace is not counted) over the HBM peak, against the flops of
    the visible positions and the current token, 2 * (2 kvr + dr) per token
    and head, over the bf16 peak (the operands' type). Also returns the time
    of the same flops on the fp32 CUDA cores, where the first design did
    them."""
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


def _mla_split_plan(c, cfg, n_split=None):
    """The split plan K3/K4 launch with on this card for case c."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    B, H_, kvr = c["qa"].shape
    return PA.mla_split_plan_for(cfg, B, H_, P, kvr, c["qr"].shape[-1],
                                 c["pt"].shape[1], sms, n_split)


def _mla_workspace(c, plan):
    """(bytes of the fp32 workspace a K3/K4 call allocates, bytes its
    non-empty splits write, bytes of the visible pages, bytes the split
    kernel reads of them: once per block of 64 heads)."""
    B, H_, kvr = c["qa"].shape
    row = H_ * (kvr + 2) * 4
    written = pages = 0
    for n in c["lens"].tolist():
        hi = -(-n // P)
        per = -(-hi // plan.n_split)
        written += (-(-hi // per) if per else 0) * row
        pages += hi * P * (kvr + DR) * 2
    return (B * plan.n_split * row, written, pages,
            pages * -(-H_ // PA.MLA_HEADS))


def _mla_planted_faults(c, want, layer, scale, n_split):
    """Wrong answers the limit must reject, on the mixed case: the last
    visible page of the length-1000 row skipped, the current token not
    folded in, and the merge with one split (of the n_split the plan gave)
    left out."""
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
        f"split {n_split // 2} of {n_split} left out of the merge":
            PA.paged_mla_decode_split_ref(
                *args, c["lens"], c["cn"], c["rn"], scale=scale,
                n_split=n_split, drop_split=n_split // 2),
    }
    for what, bad in faults.items():
        if _close(bad, want):
            raise AssertionError(f"the bf16 limit lets a planted fault through: "
                                 f"{what}")
    print(f"[kernels-mla] planted faults rejected by the limit: "
          f"{', '.join(faults)}")


def phase_kernels_mla():
    """K3/K4 (split-KV: a split and a merge kernel per call) against their
    plain versions at deepseek-v2 widths."""
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
            plan = _mla_split_plan(c, cfg)
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
                _mla_planted_faults(dict(c, cp=cp0, rp=rp0), want, layer,
                                    scale, plan.n_split)
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
    plan = _mla_split_plan(c, cfg)
    alloc, written, page_bytes, page_reads = _mla_workspace(c, plan)
    print(f"[kernels-mla] split plan: {plan.n_split} splits of <= "
          f"{plan.pages_per_split} pages, ring d={plan.distance}, {plan.slots} "
          f"slots, {plan.smem_bytes} B a block (grid {plan.n_split} x "
          f"{-(-MLA_H // PA.MLA_HEADS)} x 8); fp32 workspace {alloc} B "
          f"allocated, {written} B written by the non-empty splits and read "
          f"by the merge, beside {page_bytes} B of visible pages "
          f"({page_reads} B read by the split blocks)")
    forced = {n: _time_ms(lambda: PA.pul_paged_sweep_mla_decode_attention(
        *args3, scale=scale, cfg=cfg, n_split=n))
        for n in (1, 2, 4, 8, 16, 32, 64)}
    print("[kernels-mla] K3 ms by forced split count: " + ", ".join(
        f"{n}: {ms:.4f}" for n, ms in forced.items()))
    # every row at the longest length: all 128 blocks stream 8 pages, so the
    # time follows the pages, not the longest row alone
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
                        bound_by=bound_by, body=PA.MLA_BODY)
    return out


# ---------------------------------------------------------------------- #
def phase_kernels_gather():
    """K5 against its plain version, bitwise: the general gather in three
    types at three distances and both issue orders, then the page form at
    the serving geometry (8 slots x 64 pages of the engine's 516 frames) at
    the page width of every served model (qwen3, deepseek and
    SERVED_MODELS', whose rows of up to 384 KB change the bulk plan's
    chunks a page), with planted faults, times and bounds."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    for dtype in (torch.float32, torch.bfloat16, torch.int32):
        table = (torch.randn((64, 256), generator=gen, device=dev)
                 * 100).to(dtype)
        trace = torch.randint(0, 64, (40,), generator=gen, device=dev,
                              dtype=torch.int32)
        want = gather_ref(table, trace)
        for d in (1, 2, 8):
            for strategy in IssueStrategy:
                got = pul_gather(table, trace,
                                 cfg=PULConfig(distance=d, strategy=strategy))
                if not torch.equal(got, want):
                    raise AssertionError(f"pul_gather {dtype} d={d} "
                                         f"{strategy.name}: not bitwise equal")
    print("[kernels-gather] pul_gather (64, 256), 40 requests, f32/bf16/int32,"
          " d in {1, 2, 8}, BATCH and SEQUENTIAL: bitwise equal")
    n_pages = MAX_SEQ // P
    NF = SLOTS * n_pages + 4            # the engine's hot frames (516)
    out = {}
    widths = [("qwen3", 2 * L * KV * HD, H // KV),
              ("deepseek", MLA_LAYERS * (KVR + DR), 1)]
    for arch in SERVED_MODELS:
        cfg = dataclasses.replace(smoke_config(arch), paged_kv=True)
        widths.append((arch, PackedKVLayout(cfg, 1, P).features,
                       cfg.num_heads // cfg.num_kv_heads))
    for label, F, gqa in widths:
        cfg = PULConfig(distance=engine_distance(F, gqa))
        plan = gather_bulk_plan(cfg, rows_per_req=P, row_bytes=F * 2)
        store = torch.randn((NF, P, F), generator=gen, device=dev,
                            dtype=torch.bfloat16)
        seed0 = torch.Generator(device=dev)
        seed0.manual_seed(0)
        pt = torch.randperm(NF, generator=seed0, device=dev)[
            :SLOTS * n_pages].reshape(SLOTS, n_pages).to(torch.int32)
        got = pul_page_gather(store, pt, cfg=cfg)
        torch.cuda.synchronize()
        want = page_gather_ref(store, pt)
        if not torch.equal(got, want):
            raise AssertionError(f"{label}: K5 differs from the plain gather")
        err = max((got[b].float() - want[b].float()).abs().max().item()
                  for b in range(SLOTS))
        neighbour = pt.clone()
        neighbour[3, 17] = (neighbour[3, 17] + 1) % NF
        short = want.clone().view(SLOTS, n_pages, P, F)
        short[:, :, P - 1] = 0
        faults = {"one page read from its neighbouring frame":
                  page_gather_ref(store, neighbour),
                  "the last row of every page left out":
                  short.view_as(want)}
        for what, bad in faults.items():
            if torch.equal(bad, got):
                raise AssertionError(f"{label}: the bitwise check lets a "
                                     f"planted fault through: {what}")
        planted = ", ".join(faults)
        del faults, short, want, got
        ms = _time_ms(lambda: pul_page_gather(store, pt, cfg=cfg))
        plain_ms = _time_ms(lambda: page_gather_ref(store, pt), reps=10)
        flat = pt.reshape(-1)
        library_ms = _time_ms(lambda: torch.index_select(store, 0, flat),
                              reps=10)
        # ten calls between two events, each after the one before rather
        # than after the timer's sleep kernel: what a launch costs on its own
        ms10 = _time_ms(lambda: [pul_page_gather(store, pt, cfg=cfg)
                                 for _ in range(10)], reps=10) / 10
        lib10 = _time_ms(lambda: [torch.index_select(store, 0, flat)
                                  for _ in range(10)], reps=10) / 10
        nbytes = 2 * SLOTS * n_pages * P * F * 2 + pt.numel() * 4
        bound_ms = nbytes / HBM_PEAK * 1e3
        print(f"[kernels-gather] {label} store {tuple(store.shape)} bf16, page "
              f"table {tuple(pt.shape)}: K5 {ms:.4f} ms (bulk plan: chunks of "
              f"{plan.chunk_bytes} B x {plan.n_chunks} a page, d="
              f"{plan.distance} of the engine's {cfg.distance}, {plan.slots} "
              f"slots, {plan.smem_bytes} B a block); index_select "
              f"{library_ms:.4f} ms ({ms / library_ms:.3f}x); back to back "
              f"K5 {ms10:.4f} ms, index_select {lib10:.4f} ms; plain "
              f"{plain_ms:.4f} ms; bound {bound_ms:.4f} ms (bytes: {nbytes} B);"
              f" planted faults rejected: {planted}")
        out[label] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by="bytes",
                          library_ms=library_ms, body=GATHER_BODY)
        del store
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------- #
# dense attention: the flash attention K7 through ops.attention_op and the
# decode attention K6 over a dense cache. Widths of qwen3-1.7b (16 query
# heads over 8 kv heads, hd 128), of gemma2-27b (32 over 16, hd 128,
# attention softcap 50 and sliding window 4096: arXiv:2408.00118), of
# qwen2.5-32b (40 over 8: a group of 5, which does not divide 64 rows;
# the published Qwen2.5-32B config) and of gemma3-12b's local layers (16
# over 8, hd 256, sliding window 1024; the published Gemma 3 12B config).
#: label, (B, H, K, T, S, hd), type, options, q's scale (8 on the softcap
#: case, so that its logits reach the cap)
ATTN = (
    ("K7-prefill", (2, H, KV, 4096, 4096, HD), torch.bfloat16, {}, 1.0),
    ("K7-chunk", (2, H, KV, 512, 4096, HD), torch.bfloat16, {}, 1.0),
    ("K7-gemma2", (1, 32, 16, 1024, 8192, 128), torch.bfloat16,
     dict(softcap=50.0, window=4096), 8.0),
    ("K7-f32", (2, H, KV, 1024, 1024, HD), torch.float32, {}, 1.0),
    ("K7-qwen2.5-32b", (1, 40, 8, 4096, 4096, 128), torch.bfloat16, {}, 1.0),
    ("K7-gemma3-12b", (1, 16, 8, 4096, 4096, 256), torch.bfloat16,
     dict(window=1024), 1.0),
)
#: K6: qwen3-1.7b decode over a dense cache of S positions, 8 rows
DECODE_S = 32768
DECODE_LENGTHS = (32768, 30000, 16384, 8193, 4096, 1000, 129, 1)
#: the rings every case is held at: d in {1, 4}, both issue orders
ATTN_RINGS = tuple(PULConfig(distance=d, strategy=s)
                   for d in (1, 4) for s in IssueStrategy)


def _dense_err(got, want):
    """Error over the limit (<= 1 holds): bf16, two bf16 ulps of each row's
    largest |value|; f32, rtol = atol = 3e-4."""
    err = (got.float() - want.float()).abs()
    if want.dtype == torch.bfloat16:
        return (err / _bf16_limit(want)).max().item()
    return (err / (3e-4 + 3e-4 * want.float().abs())).max().item()


def _dense_check(got, want, what):
    ratio = _dense_err(got, want)
    if not ratio <= 1.0:
        raise AssertionError(f"{what}: error up to {ratio:.2f} x the limit")
    return (got.float() - want.float()).abs().max().item()


def _visible_pairs(T, S, causal=True, window=None):
    """(query, key) pairs the mask leaves visible, per (b, h)."""
    iq = np.arange(T) + (S - T)
    hi = np.minimum(S, iq + 1) if causal else np.full(T, S)
    lo = np.maximum(0, iq - window + 1) if window else np.zeros(T, np.int64)
    return int(np.maximum(0, hi - lo).sum())


def _attn_bound(shape, dtype, opts):
    """Flops of the visible pairs (4 hd each) over the peak of the operands'
    type, against q, k, v and out moved once."""
    B, Hq, K, T, S, hd = shape
    pairs = B * Hq * _visible_pairs(T, S, opts.get("causal", True),
                                    opts.get("window"))
    item = torch.tensor([], dtype=dtype).element_size()
    peak = BF16_TC_PEAK if dtype == torch.bfloat16 else FP32_PEAK
    t_ops = 4.0 * hd * pairs / peak * 1e3
    t_bytes = (2 * B * Hq * T + 2 * B * K * S) * hd * item / HBM_PEAK * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes",
            4.0 * hd * pairs)


def _sdpa(q, k, v, **kw):
    """One call of scaled_dot_product_attention on the same inputs (GQA
    in the call where this PyTorch takes enable_gqa, else K/V repeated here,
    outside the timed call): the yardstick, never called by the port."""
    F = torch.nn.functional
    try:
        F.scaled_dot_product_attention(q, k, v, enable_gqa=True, **kw)
        return lambda: F.scaled_dot_product_attention(q, k, v,
                                                      enable_gqa=True, **kw)
    except TypeError:
        G = q.shape[1] // k.shape[1]
        kk = k.repeat_interleave(G, dim=1)
        vv = v.repeat_interleave(G, dim=1)
        return lambda: F.scaled_dot_product_attention(q, kk, vv, **kw)


def _decode_inputs(gen, dev):
    B = len(DECODE_LENGTHS)
    q = torch.randn((B, H, HD), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((B, KV, DECODE_S, HD), generator=gen,
                    device=dev).to(torch.bfloat16)
    v = torch.randn((B, KV, DECODE_S, HD), generator=gen,
                    device=dev).to(torch.bfloat16)
    lens = torch.tensor(DECODE_LENGTHS, dtype=torch.int32, device=dev)
    return q, k, v, lens


def _decode_bound(lengths):
    """(bytes, byte time, flop time) of K6 at these lengths: the visible K
    and V rows, q and out, the lengths; 4 G hd flops a visible key."""
    visible = sum(lengths)
    nbytes = (visible * KV * HD * 2 * 2 + 2 * len(lengths) * H * HD * 2
              + len(lengths) * 4)
    return (nbytes, nbytes / HBM_PEAK * 1e3,
            4.0 * H * HD * visible / BF16_TC_PEAK * 1e3)


def _decode_plan(dev, cfg=PULConfig(), seg_chunks=None):
    """K6's plan at the smoke's shapes, with the card's occupancy."""
    plan = decode_ring_plan(cfg, B=len(DECODE_LENGTHS), K=KV, G=H // KV,
                            s_pad=DECODE_S, hd=HD, itemsize=2,
                            seg_chunks=seg_chunks)
    if dev.type != "cuda":
        return plan
    bps = _blocks_per_sm("pul_dense_attention", HD, 1, H // KV,
                         plan.smem_bytes)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return dataclasses.replace(plan, blocks_per_sm=bps, grid=sms * bps)


def phase_kernels_attn(device="cuda"):
    """K7 and K6 on their main path (ops.attention_op at its default tiles
    and ring, pul_decode_attention), launches counted there; each case
    against its plain version, at d in {1, 4} in both issue orders, with
    planted faults; times, bounds, plain times, SDPA times. Returns the
    summary rows of k6 and k7 and their launches."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    cases = []
    for label, shape, dtype, opts, qs in ATTN:
        B, Hq, K, T, S, hd = shape
        q = (torch.randn((B, Hq, T, hd), generator=gen, device=dev)
             * qs).to(dtype)
        k = torch.randn((B, K, S, hd), generator=gen, device=dev).to(dtype)
        v = torch.randn((B, K, S, hd), generator=gen, device=dev).to(dtype)
        cases.append((label, shape, dtype, opts, q, k, v))
    q6, k6, v6, lens = _decode_inputs(gen, dev)

    # the slice's main path, counts from 0
    for key in PA.LAUNCHES:
        PA.LAUNCHES[key] = 0
    outs = [ops.attention_op(q, k, v, **opts)
            for _, _, _, opts, q, k, v in cases]
    out6 = pul_decode_attention(q6, k6, v6, lens)
    _sync(device)
    launches = {k: PA.LAUNCHES[k] for k in ("k6", "k7", "k7_tc")}
    n_bf16 = sum(c[2] == torch.bfloat16 for c in cases)
    if launches != {"k6": 1, "k7": len(cases), "k7_tc": n_bf16}:
        raise AssertionError(f"the main path launched {launches}, not K7 "
                             f"{len(cases)} times ({n_bf16} bf16 cases on the "
                             "tensor-core body) and K6 once")

    rows, k7_err = {}, 0.0
    for (label, shape, dtype, opts, q, k, v), got in zip(cases, outs):
        want = PA.attention_kernel_ref(q, k, v, **opts)
        err = _dense_check(got, want, f"{label} via ops.attention_op")
        for cfg in ATTN_RINGS:
            err = max(err, _dense_check(
                PA.pul_attention(q, k, v, cfg=cfg, **opts), want,
                f"{label} d={cfg.distance} {cfg.strategy.name}"))
        k7_err = max(k7_err, err)
        kz, vz = k.clone(), v.clone()
        kz[:, :, -128:] = 0
        vz[:, :, -128:] = 0
        faults = {"the last KV block zeroed":
                  PA.attention_kernel_ref(q, kz, vz, **opts)}
        del kz, vz
        if opts.get("softcap"):
            faults["the softcap dropped"] = PA.attention_kernel_ref(
                q, k, v, **dict(opts, softcap=None))
        for what, bad in faults.items():
            if _dense_err(bad, want) <= 1.0:
                raise AssertionError(f"{label}: the limit lets a planted "
                                     f"fault through: {what}")
        planted = ", ".join(faults)
        del want, faults
        ms = _time_ms(lambda: ops.attention_op(q, k, v, **opts))
        plain_ms = _time_ms(lambda: PA.attention_kernel_ref(q, k, v, **opts),
                            reps=5)
        B, Hq, K, T, S, hd = shape
        library_ms = None
        if not opts.get("softcap"):
            # SDPA's is_causal aligns the queries to the first keys; with
            # T < S or a window the end-aligned mask goes in as a boolean
            # mask (every row sees a key there, so SDPA's value is K7's)
            iq = torch.arange(T, device=dev)[:, None] + (S - T)
            jk = torch.arange(S, device=dev)[None, :]
            mask = jk <= iq
            if opts.get("window"):
                mask = mask & (jk > iq - opts["window"])
            kw = (dict(is_causal=True) if T == S and not opts
                  else dict(attn_mask=mask))
            library_ms = _time_ms(_sdpa(q, k, v, **kw))
            del mask
        bound_ms, bound_by, flops = _attn_bound(shape, dtype, opts)
        body = PA.attention_body(dtype)
        rows[label] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                           bound_ms=bound_ms, bound_by=bound_by,
                           library_ms=library_ms, body=body)
        lib_txt = ("none (no single PyTorch call applies the softcap)"
                   if library_ms is None else
                   f"SDPA {library_ms:.4f} ms (K7 {ms / library_ms:.2f} x)")
        print(f"[kernels-attn] {label} B={B} H={Hq} K={K} T={T} S={S} "
              f"hd={hd} {str(dtype).split('.')[-1]}"
              f"{' ' + str(opts) if opts else ''} body {body}: max|K7-plain| "
              f"{err:.3e} within the limit via ops.attention_op and at d=1/4 "
              f"BATCH/SEQUENTIAL; planted faults rejected: "
              f"{planted}; K7 {ms:.4f} ms "
              f"({flops / ms / 1e9:.1f} TFLOP/s visible), plain "
              f"{plain_ms:.4f} ms, {lib_txt}, bound {bound_ms:.4f} ms "
              f"({bound_by}, {flops / 1e9:.1f} GFLOP visible)")
    del cases, outs
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # K6
    want = decode_attention_kernel_ref(q6, k6, v6, lens)
    err6 = _dense_check(out6, want, "K6 at the default ring")
    for cfg in ATTN_RINGS:
        err6 = max(err6, _dense_check(
            pul_decode_attention(q6, k6, v6, lens, cfg=cfg), want,
            f"K6 d={cfg.distance} {cfg.strategy.name}"))
    plan = _decode_plan(dev)
    seg, pieces = decode_pieces(plan, DECODE_LENGTHS, KV)
    n_segs = -(-sum(c1 - c0 for cuts in pieces.values() for c0, c1 in cuts)
               // seg)
    faults = {}
    for what, row, cut in (("the length-129 row's second chunk left out",
                            DECODE_LENGTHS.index(129), 64),
                           ("the longest row's last 2048 keys left out", 0,
                            DECODE_S - 2048)):
        short = lens.clone()
        short[row] = cut
        faults[what] = decode_attention_kernel_ref(q6, k6, v6, short)
    faults["one segment's piece of every long row left out of the merge"] = (
        decode_attention_split_ref(q6, k6, v6, lens, plan=plan, drop_piece=1))
    for what, bad in faults.items():
        if _dense_err(bad, want) <= 1.0:
            raise AssertionError(f"K6: the limit lets a planted fault "
                                 f"through: {what}")
    planted = "; ".join(faults)
    del want, faults
    ms = _time_ms(lambda: pul_decode_attention(q6, k6, v6, lens))
    plain_ms = _time_ms(lambda: decode_attention_kernel_ref(q6, k6, v6, lens),
                        reps=5)
    mask = (torch.arange(DECODE_S, device=dev)[None, :]
            < lens[:, None])[:, None, None, :]
    library_ms = _time_ms(_sdpa(q6[:, :, None], k6, v6, attn_mask=mask))
    nbytes, t_bytes, t_ops = _decode_bound(DECODE_LENGTHS)
    rows["K6"] = dict(max_abs_err=err6, ms=ms, plain_ms=plain_ms,
                      bound_ms=max(t_bytes, t_ops),
                      bound_by="bytes" if t_bytes >= t_ops else "operations",
                      library_ms=library_ms, body=DECODE_BODY)
    print(f"[kernels-attn] K6 B=8 H={H} K={KV} S={DECODE_S} bf16 lengths "
          f"{list(DECODE_LENGTHS)}, body {DECODE_BODY} (chunks of "
          f"{plan.chunk_keys} keys, d={plan.distance}, {plan.slots} slots, "
          f"{plan.smem_bytes} B a block, {plan.blocks_per_sm} blocks/SM, "
          f"grid {plan.grid}; {n_segs} segments of {seg} chunks, at most "
          f"{max(map(len, pieces.values()))} pieces a row): max|K6-plain| "
          f"{err6:.3e} within the limit at the default ring and at d=1/4 "
          f"BATCH/SEQUENTIAL; planted faults rejected: {planted}; K6 "
          f"{ms:.4f} ms ({nbytes / ms / 1e6:.1f} GB/s of visible K/V), plain "
          f"{plain_ms:.4f} ms, SDPA with a length mask {library_ms:.4f} ms "
          f"(K6 {ms / library_ms:.2f} x), bound {rows['K6']['bound_ms']:.4f} "
          f"ms ({rows['K6']['bound_by']}, {nbytes} B)")
    # every row at the full cache: the same path, the most bytes
    full = torch.full_like(lens, DECODE_S)
    err = _dense_check(pul_decode_attention(q6, k6, v6, full),
                       decode_attention_kernel_ref(q6, k6, v6, full),
                       "K6 every row at 32768")
    full_ms = _time_ms(lambda: pul_decode_attention(q6, k6, v6, full))
    fbytes, ft_bytes, _ = _decode_bound((DECODE_S,) * len(DECODE_LENGTHS))
    print(f"[kernels-attn] K6 every row at {DECODE_S}: max|K6-plain| "
          f"{err:.3e} within the limit; K6 {full_ms:.4f} ms "
          f"({fbytes / full_ms / 1e6:.1f} GB/s), bound {ft_bytes:.4f} ms "
          f"(bytes, {fbytes} B), {full_ms / ft_bytes:.2f} x")
    rows["K6-full"] = dict(ms=full_ms, bound_ms=ft_bytes, max_abs_err=err)
    out = {"k7": dict(rows["K7-prefill"], max_abs_err=k7_err),
           "k6": rows["K6"]}
    return out, launches, rows


# ---------------------------------------------------------------------- #
# the paper's microbenchmarks: K8 (SUM), K9 (filter), K10 (matmul)
#: the SUM/filter table: 2^26 rows of 16 f32 (the paper's 64-byte transfer
#: unit), 4 GiB, and 2^24 random requests of one row
MICRO_ROWS, MICRO_W, MICRO_REQS = 2 ** 26, 16, 2 ** 24
#: K10's products, through ops.matmul_op at its default tiles: label, n, the
#: inputs' type, the output's type
MATMULS = (("4096^3 bf16 -> f32", 4096, torch.bfloat16, torch.float32),
           ("2048^3 f32", 2048, torch.float32, torch.float32),
           ("4096^3 bf16 -> bf16", 4096, torch.bfloat16, torch.bfloat16))


def _micro_table(gen, dev):
    """The 4 GiB table: normal values rounded to multiples of 1/8, |x| below
    8. Every partial sum of up to 2^28 of them, in any order, is a multiple
    of 1/8 far below 2^21 and so exact in fp32: the SUM must equal the fp64
    sum bit for bit, and one request left out shows."""
    t = torch.randn((MICRO_ROWS, MICRO_W), generator=gen, device=dev)
    return t.mul_(8).round_().clamp_(-63, 63).div_(8)


def _k8_case(table, trace, rows_per_req):
    """(the exact sum, sum |x|, the sum with the request of the largest |row
    sum| left out) of the requests of `trace`, r = rows_per_req, in fp64."""
    rows = table.view(-1, rows_per_req * MICRO_W)[trace.long()].double()
    per_req = rows.sum(1)
    want = per_req.sum().item()
    worst = per_req.abs().argmax()
    return want, rows.abs().sum().item(), want - per_req[worst].item()


def _k8_bound(n_req, req_bytes):
    """Least time for K8: each request's bytes and trace entry read once and
    the sum written once, over the HBM peak."""
    return (n_req * (req_bytes + 4) + 4) / HBM_PEAK * 1e3


#: the least the card reads of a row: the 64-byte DRAM fetch that holds
#: column 0, which sector_probe() shows the card making for a 16- or 32-byte
#: read of each 64-byte row (measured on one H100)
FETCH = 64


def _k9_bytes(materialize, kept, row_bytes=None, n_rows=None):
    """(least bytes K9's function moves, bytes the kernel moves) on a table
    of n_rows rows of row_bytes, `kept` rows passing. The predicate needs
    column 0, which the card fetches in the 64-byte unit holding it (the
    whole row where rows are 64 B or shorter); materialize also reads the
    rest of each kept row and writes the whole table, bit-vector writes the
    words. The bit-vector kernel's TMA tiles read min(row, 64) B of each
    row; materialize reads rows whole. Default: the smoke's f32 table."""
    row_bytes = row_bytes or MICRO_W * 4
    n_rows = n_rows or MICRO_ROWS
    table = n_rows * row_bytes
    col0 = n_rows * min(row_bytes, FETCH)
    if materialize:
        return col0 + kept * (row_bytes - min(row_bytes, FETCH)) + table, \
            2 * table
    return col0 + n_rows // 8, col0 + n_rows // 8


def _words(t):
    """uint32 words viewed as int32 (few PyTorch kernels take uint32)."""
    return t.view(torch.int32) if t.dtype == torch.uint32 else t


def _matmul_limit(a, b, out_dtype=torch.float32):
    """2 sqrt(K) 2^-24 (|A| |B|): the random-walk size of fp32 rounding in a
    K-term sum with every partial sum at its largest, sum |a b|; for a bf16
    output one bf16 rounding of the result, 2^-8 |A B|, on top."""
    K = a.shape[1]
    limit = 2.0 * math.sqrt(K) * 2.0 ** -24 * (a.float().abs() @ b.float().abs())
    if out_dtype == torch.bfloat16:
        limit += 2.0 ** -8 * (a.float() @ b.float()).abs()
    return limit


def phase_kernels_micro(device="cuda"):
    """K8 and K9 on a 4 GiB table, K10 through ops.matmul_op, each against
    its plain version, with planted faults, times and bounds. Returns the
    kernels' summary rows, K10's launches and the table for phase paper."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    table = _micro_table(gen, dev)
    trace = torch.randint(0, MICRO_ROWS, (MICRO_REQS,), generator=gen,
                          device=dev, dtype=torch.int32)
    out = {}
    # K8: exact on eighths, at four ring settings
    want, abs_sum, skipped = _k8_case(table, trace, 1)
    limit = 8 * 2.0 ** -24 * abs_sum
    err = 0.0
    for cfg in (PULConfig(), PULConfig(distance=1), PULConfig(distance=16),
                PULConfig(distance=4, strategy=IssueStrategy.SEQUENTIAL)):
        got = pul_sum(table, trace, cfg=cfg).item()
        err = max(err, abs(got - want))
        if got != want:
            raise AssertionError(f"K8 d={cfg.distance} {cfg.strategy.name}: "
                                 f"{got!r} != the exact sum {want!r}")
    if skipped == want:
        raise AssertionError("the exact check lets a planted fault through: "
                             "one request skipped")
    plain = sum_ref(table, trace).item()
    ms = _time_ms(lambda: pul_sum(table, trace))
    plain_ms = _time_ms(lambda: sum_ref(table, trace), reps=10)
    bound = _k8_bound(MICRO_REQS, 64)
    print(f"[kernels-micro] K8 table {tuple(table.shape)} f32 "
          f"({table.numel() * 4 / 2 ** 30:.0f} GiB), "
          f"{MICRO_REQS} requests of 64 B: == the fp64 sum {want!r} exactly "
          f"at d=4/1/16 BATCH and d=4 SEQUENTIAL (plain fp32 sum {plain!r}; "
          f"the Sigma|x| limit 8 * 2^-24 * {abs_sum:.1f} = {limit:.4f}); "
          f"planted fault rejected: one request skipped (sum {skipped!r}); "
          f"K8 {ms:.4f} ms, plain {plain_ms:.4f} ms, library: none (no "
          f"single PyTorch call gathers and sums), bound {bound:.4f} ms "
          f"(bytes)")
    out["k8"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                     bound_ms=bound, bound_by="bytes", library_ms=None)
    # K9: bitwise in both modes at both unload distances
    want_bv = filter_ref(table, 0.25)
    bad = want_bv.clone()
    w = int((_words(bad) != 0).nonzero()[0])
    word = int(_words(bad)[w]) & 0xFFFFFFFF
    rev = int(f"{word:032b}"[::-1], 2)
    if rev == word:
        raise AssertionError("the planted fault's word is a bit palindrome")
    _words(bad)[w] = rev - (1 << 32) if rev >= 1 << 31 else rev
    for materialize in (False, True):
        want9 = filter_materialize_ref(table, 0.25) if materialize else want_bv
        for ud in (0, 1):
            got = pul_filter(table, 0.25, rows_per_block=128,
                             materialize=materialize,
                             cfg=PULConfig(unload_distance=ud))
            if not torch.equal(_words(got), _words(want9)):
                raise AssertionError(f"K9 materialize={materialize} "
                                     f"unload_distance={ud}: not bitwise "
                                     "equal to the plain version")
            if not materialize and torch.equal(_words(got), _words(bad)):
                raise AssertionError("the bitwise check lets a planted "
                                     "fault through: one word reversed")
            del got
        del want9
    plan = filter_ring_plan(PULConfig(), rows=128, width=MICRO_W,
                            materialize=False, n_rows=MICRO_ROWS)
    bps = (_blocks_per_sm("pul_filter", 0, 0, plan.smem_bytes)
           if dev.type == "cuda" else "not queried")
    ms = _time_ms(lambda: pul_filter(table, 0.25))
    plain_ms = _time_ms(lambda: filter_ref(table, 0.25), reps=10)
    kept = int((table[:, 0] > 0.25).sum())
    nbytes, moved = _k9_bytes(False, kept)
    bound = nbytes / HBM_PEAK * 1e3
    mat_ms = _time_ms(lambda: pul_filter(table, 0.25, materialize=True))
    mat_plan = filter_ring_plan(PULConfig(), rows=128, width=MICRO_W,
                                materialize=True)
    mat_bytes, mat_moved = _k9_bytes(True, kept)
    print(f"[kernels-micro] K9 the same table, rows_per_block 128, threshold "
          f"0.25 ({kept} rows kept): bitwise equal in both modes at "
          f"unload_distance 0 and 1; planted fault rejected: word {w}'s bit "
          f"order reversed; bit-vector body {plan.body} (tiles of "
          f"{plan.box_rows} rows x {plan.tile_bytes} B, slots of "
          f"{plan.slot_bytes} B, d={plan.distance}, {plan.slots} slots, "
          f"{plan.smem_bytes} B a block, {bps} blocks/SM): K9 bit-vector "
          f"{ms:.4f} ms ({moved / ms / 1e6:.1f} GB/s), plain {plain_ms:.4f} "
          f"ms, library: none, bound {bound:.4f} ms (bytes: {nbytes} B, the "
          f"{FETCH}-byte fetch holding column 0 of each row and the words); "
          f"materialize (body {mat_plan.body}) {mat_ms:.4f} ms, bound "
          f"{mat_bytes / HBM_PEAK * 1e3:.4f} ms ({mat_bytes} B; it moves "
          f"{mat_moved} B)")
    out["k9"] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                     bound_ms=bound, bound_by="bytes", library_ms=None,
                     body=plan.body)
    del want_bv, bad
    # K9 on a bf16 table of the same values (eighths are exact in bf16):
    # 32-byte rows, two to a fetch
    tb = table.to(torch.bfloat16)
    for materialize in (False, True):
        want9 = (filter_materialize_ref if materialize else filter_ref)(
            tb, 0.25)
        for ud in (0, 1):
            got = pul_filter(tb, 0.25, materialize=materialize,
                             cfg=PULConfig(unload_distance=ud))
            if not torch.equal(_words(got), _words(want9)):
                raise AssertionError(f"K9 bf16 materialize={materialize} "
                                     f"unload_distance={ud}: not bitwise "
                                     "equal to the plain version")
            del got
        del want9
    bf_plan = filter_ring_plan(PULConfig(), rows=128, width=MICRO_W,
                               materialize=False, itemsize=2,
                               n_rows=MICRO_ROWS)
    bf_ms = _time_ms(lambda: pul_filter(tb, 0.25))
    bf_mat_ms = _time_ms(lambda: pul_filter(tb, 0.25, materialize=True))
    bf_bytes = _k9_bytes(False, kept, MICRO_W * 2)[0]
    bf_mat = _k9_bytes(True, kept, MICRO_W * 2)[0]
    print(f"[kernels-micro] K9 bf16 table {tuple(tb.shape)} "
          f"({tb.numel() * 2 / 2 ** 30:.0f} GiB, 32-byte rows): bitwise equal in both modes at unload_distance 0 and 1; "
          f"tiles of {bf_plan.tile_bytes} B ({bf_plan.body}); bit-vector "
          f"{bf_ms:.4f} ms, "
          f"bound {bf_bytes / HBM_PEAK * 1e3:.4f} ms ({bf_bytes} B); "
          f"materialize {bf_mat_ms:.4f} ms, bound "
          f"{bf_mat / HBM_PEAK * 1e3:.4f} ms ({bf_mat} B)")
    del tb
    # K10 through the path's entry point, ops.matmul_op
    cases = []
    for label, n, dtype, out_dtype in MATMULS:
        a = torch.randn((n, n), generator=gen, device=dev).to(dtype)
        b = torch.randn((n, n), generator=gen, device=dev).to(dtype)
        cases.append((label, a, b, out_dtype))
    for k in PA.LAUNCHES:
        PA.LAUNCHES[k] = 0
    outs = [ops.matmul_op(a, b, out_dtype=od) for _, a, b, od in cases]
    _sync(device)
    k10_launches = PA.LAUNCHES["k10"]
    n_tc = sum(matmul_body(a.dtype, 128, 128) == "wgmma"
               for _, a, _, _ in cases)
    if (k10_launches, PA.LAUNCHES["k10_wgmma"]) != (len(cases), n_tc):
        raise AssertionError(f"ops.matmul_op launched K10 {k10_launches} "
                             f"times, {PA.LAUNCHES['k10_wgmma']} on the "
                             f"tensor cores, for {len(cases)} products "
                             f"({n_tc} bf16)")
    k10 = None
    for (label, a, b, out_dtype), got in zip(cases, outs):
        want = matmul_ref(a, b)
        limit = _matmul_limit(a, b, out_dtype)
        err = (got.float() - want).abs()
        if not bool((err <= limit).all()):
            raise AssertionError(f"K10 {label}: error up to "
                                 f"{(err / limit).max().item():.2f} x the "
                                 "limit")
        body = matmul_body(a.dtype, 128, 128)
        plan = (matmul_tc_plan(PULConfig(), bm=128, bk=128, bn=128)
                if body == "wgmma" else
                matmul_ring_plan(PULConfig(), bm=128, bk=128, bn=128,
                                 itemsize=a.element_size()))
        c = plan.bk_chunk
        bad = want - a[:, :c].float() @ b[:c].float()
        if bool(((bad - want).abs() <= limit).all()):
            raise AssertionError(f"K10 {label}: the limit lets a planted "
                                 "fault through: one K chunk left out")
        del bad
        ms = _time_ms(lambda: ops.matmul_op(a, b, out_dtype=out_dtype),
                      reps=10)
        plain_ms = _time_ms(lambda: matmul_ref(a, b), reps=10)
        library_ms = _time_ms(lambda: torch.matmul(a, b), reps=10)
        n = a.shape[0]
        peak = BF16_TC_PEAK if a.dtype == torch.bfloat16 else FP32_PEAK
        t_ops = 2.0 * n ** 3 / peak * 1e3
        out_item = torch.tensor([], dtype=out_dtype).element_size()
        t_bytes = (2 * n * n * a.element_size() + n * n * out_item) / HBM_PEAK * 1e3
        row = dict(max_abs_err=err.max().item(), ms=ms, plain_ms=plain_ms,
                   bound_ms=max(t_ops, t_bytes),
                   bound_by="operations" if t_ops >= t_bytes else "bytes",
                   library_ms=library_ms, body=body)
        print(f"[kernels-micro] K10 {label} via ops.matmul_op (tiles 128^3, "
              f"body {body}, K chunk {c}, d {plan.distance}, {plan.slots} "
              f"slots): max|K10-plain| {row['max_abs_err']:.3e} (limit "
              f"2 sqrt(K) 2^-24 (|A||B|)"
              f"{' + 2^-8 |AB|' if out_dtype == torch.bfloat16 else ''}, up to "
              f"{limit.max().item():.3e}); planted fault rejected: one K "
              f"chunk left out; K10 {ms:.4f} ms ({2.0 * n ** 3 / ms / 1e9:.1f} "
              f"TFLOP/s), plain {plain_ms:.4f} ms, torch.matmul "
              f"{library_ms:.4f} ms "
              f"({'bf16 out' if a.dtype == torch.bfloat16 else 'f32'}; K10 "
              f"{ms / library_ms:.2f} x), bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
        k10 = k10 or row
        del want, limit, err
    out["k10"] = k10
    del cases, outs
    return out, k10_launches, table


def phase_paper(table, device="cuda"):
    """run_all on the card (the DMA twin's Exps. 1-5 and the functional
    sweep through K8 and K9), every claim PASS; then CUDA-event times of K8
    over the figures' knobs at the 4 GiB table (each result checked against
    the exact sum) and of K9 in each mode at both unload distances."""
    from repro_torch.benchmarks import paper_experiments as PE
    for k in PA.LAUNCHES:
        PA.LAUNCHES[k] = 0
    rows, claims = PE.run_all(device=device)
    _sync(device)
    launches = {k: PA.LAUNCHES[k] for k in ("k8", "k9")}
    for r in rows:
        print(f"[paper] {r}")
    for c in claims:
        print(f"[paper] {c}")
    failed = [c for c in claims if ": PASS (" not in c]
    if len(claims) != 11 or failed:
        raise AssertionError(f"paper claims failed: {failed}")
    if not (launches["k8"] and launches["k9"]):
        raise AssertionError(f"run_all launched {launches}")
    gen = torch.Generator(device=device)
    gen.manual_seed(4)
    sweep = {}

    def k8_point(label, cfg, r):
        n = MICRO_REQS // r
        trace = torch.randint(0, MICRO_ROWS // r, (n,), generator=gen,
                              device=device, dtype=torch.int32)
        want = _k8_case(table, trace, r)[0]
        got = pul_sum(table, trace, cfg=cfg, rows_per_req=r).item()
        if got != want:
            raise AssertionError(f"K8 {label}: {got!r} != {want!r}")
        plan = sum_ring_plan(cfg, req_bytes=64 * r)
        ms = _time_ms(lambda: pul_sum(table, trace, cfg=cfg, rows_per_req=r))
        gbs = n * (64 * r + 4) / ms / 1e6
        sweep[label] = ms
        print(f"[paper] k8 {label}: {ms:.4f} ms, {gbs:.1f} GB/s of requests "
              f"and trace (ring: d={plan.distance}, {plan.slots} slots, "
              f"{plan.lanes} lanes per PE); bound "
              f"{_k8_bound(n, 64 * r):.4f} ms")

    for d in (1, 2, 4, 8, 16, 32):
        for strategy in IssueStrategy:
            k8_point(f"d={d} {strategy.name} rows_per_req=1",
                     PULConfig(distance=d, strategy=strategy), 1)
    for r in (16, 128):
        k8_point(f"d=4 BATCH rows_per_req={r}", PULConfig(), r)
    kept = int((table[:, 0] > 0.25).sum())
    for materialize in (False, True):
        nbytes, moved = _k9_bytes(materialize, kept)
        for ud in (0, 1):
            cfg = PULConfig(unload_distance=ud)
            ms = _time_ms(lambda: pul_filter(table, 0.25,
                                             materialize=materialize, cfg=cfg))
            label = (f"{'materialize' if materialize else 'bit-vector'} "
                     f"unload_distance={ud}")
            sweep[label] = ms
            print(f"[paper] k9 {label}: {ms:.4f} ms, "
                  f"{moved / ms / 1e6:.1f} GB/s of what the kernel reads and "
                  "writes; "
                  f"bound {nbytes / HBM_PEAK * 1e3:.4f} ms ({nbytes} B)")
    print("[paper] " + json.dumps({"launches": launches, "ms": sweep}))
    return launches


class _CheckedEngine(paged_decode.GapEngine):
    """The engine with every emitted logit row checked for finiteness, each
    token's top-2 logit gap recorded, and the logits of decode steps kept
    (by request, the last step's). ``check_s`` sums the host time the
    checks take, which the tick times below leave out: they time the
    engine, not the smoke."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.decode_logits, self._decoding = {}, False

    def _decode_step(self):
        self._decoding = True
        try:
            return super()._decode_step()
        finally:
            self._decoding = False

    def _record(self, slot, logits):
        if not np.isfinite(logits).all():
            raise AssertionError(f"non-finite logits for slot {slot}")
        super()._record(slot, logits)
        if self._decoding:
            self.decode_logits[self.slot_req[slot].rid] = logits.copy()


def _tick_ms(eng):
    """One engine tick's host time in ms, the smoke's checks left out."""
    return common.tick_s(eng) * 1e3


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


#: the paged engine's decode paths: the kernel-true sweep (K1; K3 for MLA)
#: and per-layer (K2; K4) paths, each replayed from its captured CUDA graph
#: or run eagerly, and assembly through K5 or plain indexing
PATHS = {
    "sweep": dict(use_paged_kernel=True, sweep_decode=True),
    "per-layer": dict(use_paged_kernel=True, sweep_decode=False),
    "sweep-eager": dict(use_paged_kernel=True, sweep_decode=True,
                        capture_decode=False),
    "per-layer-eager": dict(use_paged_kernel=True, sweep_decode=False,
                            capture_decode=False),
    "assembly": dict(use_paged_kernel=False, use_pallas_gather=True),
    "assembly-plain": dict(use_paged_kernel=False, use_pallas_gather=False),
}


def _engine(cfg, params, path, device):
    """A checked engine at the serving geometry (SLOTS x MAX_SEQ)."""
    return _geometry_engine(cfg, params, path, device,
                            (SLOTS, MAX_SEQ, SERVE_BUCKETS))


def _path_kernel(cfg, path):
    """(the kernel the path launches, launches per decode step)."""
    mla = cfg.attn_type == "mla"
    return {"sweep": ("k3" if mla else "k1", cfg.num_layers),
            "per-layer": ("k4" if mla else "k2", cfg.num_layers),
            "assembly": ("k5", 1),
            "assembly-plain": (None, 0)}[path.removesuffix("-eager")]


def warm_up(cfg, params, device="cuda", paths=("sweep", "per-layer")):
    """One short request per prefill bucket through each decode path, so
    the timed runs below pay no first-call cost (library handles, kernel
    module load, allocator growth)."""
    for path in paths:
        eng = _engine(cfg, params, path, device)
        for i, n in enumerate((100, 200, 400)):
            eng.submit(Request(rid=i, prompt=[1 + i] * n, max_new_tokens=3))
        eng.run()
    _sync(device)


#: the serving phases' tag of each model
TAGS = {"qwen3-1.7b": "serving", DEEPSEEK: "serving-mla",
        "qwen2.5-32b": "serving-qwen2.5", "gemma2-27b": "serving-gemma2",
        "gemma3-12b": "serving-gemma3", GROK: "serving-grok",
        "internvl2-2b": "serving-internvl2",
        "musicgen-large": "serving-musicgen"}


def _tag(cfg, path):
    base = TAGS[cfg.name]
    return f"[{base}-assembly]" if path.startswith("assembly") else f"[{base}]"


def phase_serving(cfg, params, *, path, device="cuda"):
    """Serve the request script on one decode path (PATHS): through the
    sweep kernel (K1; K3 for MLA), the per-layer one (K2; K4), or assembly
    through K5 or plain indexing, with one preempt/resume mid-stream.
    Returns (tokens by request, stats, the engine's top-2 gaps)."""
    key, per_step = _path_kernel(cfg, path)
    tag = _tag(cfg, path)
    eng = _engine(cfg, params, path, device)
    for r in _requests(cfg.vocab_size):
        eng.submit(r)
    decode_ms = []              # host time of ticks that ran no prefill

    def step():
        n = eng.metrics.prefills
        ms = _tick_ms(eng)
        if eng.metrics.prefills == n:
            decode_ms.append(ms)

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
    wall = time.perf_counter() - t0 - eng.check_s
    launches = dict(PA.LAUNCHES)
    m, pm = eng.metrics, eng.pool.metrics
    pm.validate()
    if sorted(out) != list(range(12)) or any(len(v) != 24 for v in out.values()):
        raise AssertionError(f"not every request finished: "
                             f"{ {k: len(v) for k, v in out.items()} }")
    if key is not None and launches[key] != per_step * m.decode_steps:
        raise AssertionError(f"{key} launched {launches[key]} times, expected "
                             f"{per_step} x {m.decode_steps} decode steps")
    others = [k for k, n in launches.items() if n and k != key]
    if others:
        raise AssertionError(f"{others} launched on the {path} path")
    if pm.page_faults < 1 or pm.shared_hits < 1:
        raise AssertionError(f"page_faults {pm.page_faults}, shared_hits "
                             f"{pm.shared_hits}: the cold tier or prefix "
                             "sharing did not run")
    stats = {"model": cfg.name, "layers": cfg.num_layers,
             "path": f"{path} ({key.upper() if key else 'no kernel'})",
             "ticks": m.ticks, "decode_steps": m.decode_steps,
             "prefills": m.prefills, "tokens": m.tokens_emitted,
             "launches": launches[key] if key else 0, "wall_s": wall,
             "tokens_per_s": m.tokens_emitted / wall,
             "ms_per_tick": wall / m.ticks * 1e3,
             "decode_tick_ms_median": statistics.median(decode_ms),
             "decode_ticks": len(decode_ms),
             "page_faults": pm.page_faults, "evictions": pm.evictions,
             "shared_hits": pm.shared_hits,
             "bytes_hot_written": pm.bytes_hot_written,
             "preload_distance": eng.pul_distance}
    print(f"{tag} " + json.dumps(stats))
    gaps = eng.gaps
    del eng
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return out, stats, gaps


#: the long-prompt phases: 4 slots of 4096 tokens on 16-token pages, buckets
#: past 2 * KV_BLOCK = 2048, three prompts that cross 2048 tokens beside a
#: short one, 16 new tokens each; monolithic, then 1024-token chunked prefill
LONG_SLOTS, LONG_SEQ, LONG_BUCKETS = 4, 4096, (512, 1024, 2048, 4096)
LONG_PROMPTS, LONG_NEW, LONG_CHUNK = (2100, 3000, 4000, 500), 16, 1024


def _streamed_vs_dense(device="cuda", *, T=LONG_SEQ, heads=H, kv=KV, hd=HD,
                       softcap=None, window=None, tag="[serving-long]"):
    """The streamed prefill attention (online softmax over 1024-key blocks)
    against the dense one, T = S, bf16, within 2e-2 x max |out| (the CPU
    model tests' bound); both are plain torch. By default at qwen3 widths,
    T = 4096, without softcap or window."""
    from repro_torch.models import layers
    gen = torch.Generator(device=device).manual_seed(0)
    q, k, v = (torch.randn((1, T, n, hd), generator=gen,
                           device=device).to(torch.bfloat16)
               for n in (heads, kv, kv))
    kw = dict(softcap=softcap, scale=hd ** -0.5)
    mask = layers._causal_mask(T, T, window=window, device=device)
    dense = layers._attend(q, k, v, mask=mask, **kw).float()
    streamed = layers._attend_chunked(q, k, v, window=window, **kw).float()
    err = float((streamed - dense).abs().max())
    limit = 2e-2 * float(dense.abs().max())
    del dense, streamed
    if not err <= limit:
        raise AssertionError(f"streamed prefill attention differs from the "
                             f"dense one by {err} > {limit}")
    stats = {"T": T, "H": heads, "K": kv, "hd": hd, "softcap": softcap,
             "window": window, "max_abs_err": err, "limit": limit,
             "streamed_ms": _time_ms(lambda: layers._attend_chunked(
                 q, k, v, window=window, **kw), reps=5, warmup=1),
             "dense_ms": _time_ms(lambda: layers._attend(
                 q, k, v, mask=mask, **kw), reps=5, warmup=1)}
    print(f"{tag} streamed vs dense prefill attention " + json.dumps(stats))
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


#: (slots, max_seq, prefill buckets) of the long-prompt phases: 4 slots of
#: 4096, and gemma2-27b's window phase, 2 slots of 6144 tokens, past its
#: window of 4096, with prompts of 5000, 4500 and 300 tokens
LONG = (LONG_SLOTS, LONG_SEQ, LONG_BUCKETS)
WINDOW_GEOMETRY = (2, 6144, (512, 1024, 2048, 4096, 6144))
WINDOW_PROMPTS = (5000, 4500, 300)


def _geometry_engine(cfg, params, path, device, geometry, chunk=0):
    slots, max_seq, buckets = geometry
    return _CheckedEngine(cfg, params, PagedEngineConfig(
        batch_slots=slots, max_seq=max_seq, page_tokens=P,
        prefill_buckets=buckets, prefill_chunk_tokens=chunk, device=device,
        **PATHS[path]))


def _serve_long(cfg, params, path, chunk, device, geometry=LONG,
                prompts=LONG_PROMPTS):
    """The long-prompt script (`prompts`, LONG_NEW new tokens each) on one
    kernel-true path at `geometry`; returns (tokens by request, stats)."""
    key, per_step = _path_kernel(cfg, path)
    eng = _geometry_engine(cfg, params, path, device, geometry, chunk)
    rng = np.random.default_rng(1)
    for i, n in enumerate(prompts):
        eng.submit(Request(rid=i, max_new_tokens=LONG_NEW,
                           prompt=rng.integers(1, cfg.vocab_size, n).tolist()))
    for k in PA.LAUNCHES:
        PA.LAUNCHES[k] = 0
    _sync(device)
    t0 = time.perf_counter()
    out = eng.run()
    _sync(device)
    wall = time.perf_counter() - t0 - eng.check_s
    launches, m = dict(PA.LAUNCHES), eng.metrics
    if sorted(out) != list(range(len(prompts))) or any(
            len(v) != LONG_NEW for v in out.values()):
        raise AssertionError(f"long prompts on {path}: not every request "
                             f"finished: { {k: len(v) for k, v in out.items()} }")
    if launches[key] != per_step * m.decode_steps or any(
            n for k, n in launches.items() if k != key):
        raise AssertionError(f"long prompts on {path}: launches {launches}, "
                             f"expected {per_step} x {m.decode_steps} {key}")
    if bool(chunk) != (m.chunk_passes > 0):
        raise AssertionError(f"{m.chunk_passes} chunk passes at "
                             f"prefill_chunk_tokens {chunk}")
    return out, {"path": f"{path} ({key.upper()})", "ticks": m.ticks,
                 "prefills": m.prefills, "chunk_passes": m.chunk_passes,
                 "decode_steps": m.decode_steps, "launches": launches[key],
                 "wall_s": wall, "tokens_per_s": m.tokens_emitted / wall}


def _long_runs(cfg, params, tag, device, geometry=LONG, prompts=LONG_PROMPTS):
    """The long-prompt script at `geometry` through the sweep kernel and
    the per-layer one (captured), monolithic and then 1024-token chunked
    prefill: bitwise-equal tokens, every request finished, finite logits,
    launches one per layer and decode step."""
    for chunk in (0, LONG_CHUNK):
        out1, s1 = _serve_long(cfg, params, "sweep", chunk, device, geometry,
                               prompts)
        out2, s2 = _serve_long(cfg, params, "per-layer", chunk, device,
                               geometry, prompts)
        if out1 != out2:
            raise AssertionError(f"{cfg.name}: long prompts at prefill_chunk_"
                                 f"tokens {chunk}: {s2['path']} tokens differ "
                                 f"from the {s1['path']} tokens")
        print(f"{tag} " + json.dumps({
            "model": cfg.name, "slots": geometry[0], "max_seq": geometry[1],
            "prompts": prompts, "new": LONG_NEW,
            "prefill_chunk_tokens": chunk, "tokens_equal": True,
            "runs": [s1, s2]}))
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def phase_serving_long(cfg, params, device="cuda"):
    """Prompts past 2 * KV_BLOCK (2100, 3000 and 4000 tokens beside 500) on
    a max_seq 4096 engine through the sweep kernel and the per-layer one
    (captured): bitwise-equal tokens, every request finished, finite
    logits; monolithic prefill at the 4096 bucket, then 1024-token chunked
    prefill. For qwen3 first the streamed prefill attention against the
    dense one at T = S = 4096."""
    tag = "[serving-mla-long]" if cfg.attn_type == "mla" else "[serving-long]"
    if cfg.attn_type != "mla":
        _streamed_vs_dense(device)
    _long_runs(cfg, params, tag, device)


def smoke_config(arch):
    """The smoke's configuration of `arch`: full width and depth;
    deepseek-v2's depth cut to MLA_LAYERS (the dense layer 0 and 5 MoE
    layers), grok-1's to GROK_LAYERS."""
    cfg = get_config(arch)
    if arch == DEEPSEEK:
        cfg = dataclasses.replace(cfg, num_layers=MLA_LAYERS)
    if arch == GROK:
        cfg = dataclasses.replace(cfg, num_layers=GROK_LAYERS)
    return cfg


def _tick_bytes(cfg, params, eng):
    """Bytes a decode tick of `eng` must move at least, at its slots'
    present lengths: every weight once (the embedding table only for the
    rows the tick looks up, unless the head reads it whole as a tied
    table), and every cached K/V row a live slot's attention sees once (a
    local layer's within its window)."""
    nbytes = 0
    for path, t in flatten(params):
        if path == "embedding/table" and not cfg.tie_embeddings:
            nbytes += len(eng.slot_req) * t[0].numel() * t.element_size()
        else:
            nbytes += t.numel() * t.element_size()
    lengths = [int(n) for n, r in zip(eng.slot_len, eng.slot_req)
               if r is not None]
    for e in eng.layout.entries:
        row = e.layers * math.prod(e.feat) * eng.pool.dtype.itemsize
        local = e.keys[1].endswith(":local") and cfg.sliding_window
        nbytes += row * sum(min(n, cfg.sliding_window) if local else n
                            for n in lengths)
    return nbytes


def profile_decode(arch="qwen3-1.7b", path="sweep", params=None):
    """Where a decode tick's time goes: torch.profiler over 4 pure decode
    ticks of one decode path (PATHS; "sweep" and "per-layer" replay the
    captured step, "-eager" runs it eagerly) at the smoke configuration of
    `arch` (8 requests, all admitted at tick 0), with `params` (random from
    seed 0 unless given). The smoke runs it on the captured sweep of both
    models. Prints one [profile] line: over 4 ticks without the profiler,
    the wall time and the device span of the step (CUDA events around the
    replay or the eager step) and its share of the wall time; over 4 more
    under the profiler, the same, the device busy share (the kernels' time
    over the ticks' wall time), the top kernels, and the port's own kernels
    (K1-K5 on this path) by name."""
    from torch.profiler import ProfilerActivity, profile
    cfg = smoke_config(arch)
    if params is None:
        params = init_params(cfg, seed=0, device="cuda")
    warm_up(cfg, params, paths=(path,))
    eng = _engine(cfg, params, path, "cuda")
    for r in _requests(cfg.vocab_size)[:8]:
        eng.submit(r)
    for _ in range(3):
        eng.step()
    n_prefills = eng.metrics.prefills
    bound_ms = _tick_bytes(cfg, params, eng) / HBM_PEAK * 1e3
    ticks = 4                   # 3 + 2 x 4 ticks: inside 24 new tokens
    spans = []
    run = eng._run_device_step

    def timed():
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = run()
        b.record()
        spans.append((a, b))
        return out

    eng._run_device_step = timed
    # first without the profiler (its tracing costs each kernel time), then
    # the same number of ticks under it
    torch.cuda.synchronize()
    t0, c = time.perf_counter(), eng.check_s
    for _ in range(ticks):
        eng.step()
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0 - (eng.check_s - c)
    kernel_true = PATHS[path]["use_paged_kernel"]
    if len(spans) != ticks * kernel_true or (eng._captured is not None) != (
            kernel_true and PATHS[path].get("capture_decode", True)):
        raise AssertionError(f"{path}: {len(spans)} kernel-true steps in "
                             f"{ticks} ticks, captured: {eng._captured}")
    # the step's device span, on the kernel-true paths (whose device half
    # is one call; the assembly path's is not)
    span = (sum(a.elapsed_time(b) for a, b in spans) / ticks
            if kernel_true else None)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0, c = time.perf_counter(), eng.check_s
        for _ in range(ticks):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0 - (eng.check_s - c)
    if eng.metrics.prefills != n_prefills:
        raise AssertionError("a prefill ran inside the decode window")
    traced_span = (sum(a.elapsed_time(b) for a, b in spans[ticks:]) / ticks
                   if kernel_true else None)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise AssertionError("the profiler recorded no device activity")
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    # the port's own kernels, all of them: the __global__ functions of
    # csrc/, each in a top-level anonymous namespace
    csrc = "".join(p.read_text() for p in _build.CSRC_DIR.glob("*.cu"))
    names = set(re.findall(r"__global__[^{;]*?(\w+_kernel)\s*\(", csrc))
    ours = {}
    for name, ms in by_name.items():
        m = re.match(r"(?:void )?\(anonymous namespace\)::((\w+)[^(]*)", name)
        if m and m.group(2) in names:
            ours[m.group(1)] = ours.get(m.group(1), 0.0) + ms
    ops = sum(1 for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CPU
              and e.name.startswith("aten::") and e.cpu_parent is None)
    stats = {"smi": _smi("name,power.limit"), "model": cfg.name,
             "layers": cfg.num_layers, "path": path, "ticks": ticks,
             "captured": eng._captured is not None,
             "tick_byte_bound_ms": bound_ms,
             "untraced_wall_ms_per_tick": plain_wall * 1e3 / ticks,
             "untraced_step_device_span_ms_per_tick": span,
             "untraced_step_span_share": (span * ticks / (plain_wall * 1e3)
                                          if kernel_true else None),
             "wall_ms_per_tick": wall * 1e3 / ticks,
             "step_device_span_ms_per_tick": traced_span,
             "device_busy_ms_per_tick": busy / ticks,
             "device_idle_share": 1.0 - busy / (wall * 1e3),
             "kernels_per_tick": len(kernels) / ticks,
             "top_level_aten_ops_per_tick": ops / ticks,
             "top_kernels_ms_per_tick": [(n[:60], ms / ticks) for n, ms in top],
             "port_kernels_ms_per_tick": {k: ms / ticks for k, ms in ours.items()}}
    print("[profile] " + json.dumps(stats))
    return stats


def _slots_for(plan_of, blocks_of, cfg, per_sm):
    """The fewest ring slots (PULConfig.slots) at which the driver's
    occupancy query puts at most per_sm blocks on an SM; cfg when per_sm is
    None. Raises when even the most slots that fit leave more."""
    if per_sm is None:
        return cfg
    s = plan_of(cfg).slots
    while blocks_of(plan_of(cfg.replace(slots=s))) > per_sm:
        if plan_of(cfg.replace(slots=s + 1)).slots == s:
            raise ValueError(f"no slot count caps {cfg} at {per_sm} blocks")
        s += 1
    return cfg.replace(slots=s)


def slots_sweep():
    """One-off, not a phase of the smoke: K8's distance sweep and K9's
    flush orders with more ring slots (PULConfig.slots) than the distance
    needs. Slots cost shared memory, so fewer blocks fit on each SM and the
    PEs on the card shrink towards the paper's few: where the distance and
    the unload order matter on real copies. Prints one [slots] line per
    point and returns the times."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    table = _micro_table(gen, dev)
    trace = torch.randint(0, MICRO_ROWS, (MICRO_REQS,), generator=gen,
                          device=dev, dtype=torch.int32)
    want = _k8_case(table, trace, 1)[0]
    kept = int((table[:, 0] > 0.25).sum())

    def sum_plan(cfg):
        return sum_ring_plan(cfg, req_bytes=MICRO_W * 4)

    out = {}
    print(_smi("name,power.limit"))
    for per_sm in (1, 2, 4, None):
        for d in (1, 2, 4, 8, 16):
            for strategy in IssueStrategy:
                cfg = _slots_for(sum_plan,
                                 lambda p: _blocks_per_sm("pul_sum", 0,
                                                          p.smem_bytes),
                                 PULConfig(distance=d, strategy=strategy),
                                 per_sm)
                got = pul_sum(table, trace, cfg=cfg).item()
                if got != want:
                    raise AssertionError(f"K8 {got!r} != {want!r}")
                ms = _time_ms(lambda: pul_sum(table, trace, cfg=cfg))
                plan = sum_plan(cfg)
                blocks = _blocks_per_sm("pul_sum", 0, plan.smem_bytes)
                key = (f"k8 cap {per_sm} blocks/SM {blocks} d={d} "
                       f"{strategy.name}")
                out[key] = ms
                print(f"[slots] {key}: {ms:.4f} ms, "
                      f"{MICRO_REQS * 68 / ms / 1e6:.1f} GB/s ({plan.slots} "
                      f"slots, {blocks * plan.pes_per_block} PEs per SM, "
                      f"{blocks * plan.pes_per_block * d} requests in flight "
                      "per SM)")
        for materialize in (False, True):
            moved = _k9_bytes(materialize, kept)[1]

            def filter_plan(cfg):
                return filter_ring_plan(cfg, rows=128, width=MICRO_W,
                                        materialize=materialize)
            for ud in (0, 1):
                cfg = _slots_for(
                    filter_plan,
                    lambda p: _blocks_per_sm("pul_filter", int(materialize),
                                             0, p.smem_bytes),
                    PULConfig(unload_distance=ud), per_sm)
                want9 = (filter_materialize_ref if materialize
                         else filter_ref)(table, 0.25)
                got = pul_filter(table, 0.25, cfg=cfg, materialize=materialize)
                if not torch.equal(_words(got), _words(want9)):
                    raise AssertionError(f"K9 {cfg}: not bitwise equal")
                del got, want9
                ms = _time_ms(lambda: pul_filter(
                    table, 0.25, cfg=cfg, materialize=materialize))
                plan = filter_plan(cfg)
                blocks = _blocks_per_sm("pul_filter", int(materialize), 0,
                                        plan.smem_bytes)
                key = (f"k9 cap {per_sm} blocks/SM {blocks} "
                       f"{'materialize' if materialize else 'bit-vector'} "
                       f"unload_distance={ud}")
                out[key] = ms
                print(f"[slots] {key}: {ms:.4f} ms, {moved / ms / 1e6:.1f} "
                      f"GB/s of what the kernel moves ({plan.slots} slots)")
    print("[slots] " + json.dumps(out))
    return out


def sector_probe():
    """One-off, not a phase of the smoke: how many bytes the card fetches
    for a short read of a row. The probe kernel (csrc/probes/
    sector_probe.cu, built here and by nothing else) reads the first 16, 32
    or 64 B of every row of the 4 GiB table viewed as 64-, 128- and
    256-byte rows, at the card's L2 fetch granularity and at 32 B
    (cudaLimitMaxL2FetchGranularity, set here and put back); then K9's
    bit-vector on the table as 64-byte rows (tiles of the whole row) and as
    128-byte rows (tiles of its first 64 B). If a 16-byte read of a 64-byte
    row takes as long as the whole row, the card fetches 64 B for it.
    Prints one [probe] line per point and returns the times."""
    probe = ctypes.CDLL(str(_build.build("sector_probe",
                                         _build.CSRC_DIR / "probes")))
    probe.sector_probe.argtypes = [ctypes.c_void_p] * 2 + [
        ctypes.c_longlong] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    probe.l2_fetch_granularity.argtypes = [ctypes.c_int]
    from repro_torch.kernels._runtime import _ptr, _stream
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    table = _micro_table(gen, dev)
    word = torch.zeros(1, dtype=torch.int32, device=dev)
    print(_smi("name,power.limit"))
    out = {}
    default = probe.l2_fetch_granularity(-1)
    try:
        for gran in (default, 32):
            probe.l2_fetch_granularity(gran)
            for row_bytes, read in ((64, 64), (64, 16), (64, 32), (128, 128),
                                    (128, 16), (128, 64), (256, 16)):
                rows = table.numel() * 4 // row_bytes

                def run():
                    rc = probe.sector_probe(
                        _ptr(table), _ptr(word), rows, row_bytes, read,
                        132 * 8, _stream(table))
                    if rc:
                        raise RuntimeError(f"sector probe: CUDA error {rc}")
                ms = _time_ms(run)
                key = (f"L2 fetch granularity {gran}: {read} B of each of "
                       f"{rows} rows of {row_bytes} B")
                out[key] = ms
                print(f"[probe] {key}: {ms:.4f} ms ({rows * read / ms / 1e6:.1f}"
                      f" GB/s asked, {rows * max(read, FETCH) / ms / 1e6:.1f} "
                      f"GB/s at {FETCH} B a row)")
    finally:
        probe.l2_fetch_granularity(default)
    # the same bytes as 2^26 rows of 64 B (a tile of the whole row) and as
    # 2^25 rows of 128 B (a tile of its first 64 B, on the tensor map)
    for wide in (table, table.view(-1, 2 * MICRO_W)):
        row_bytes = wide.shape[1] * 4
        want = filter_ref(wide, 0.25)
        got = pul_filter(wide, 0.25)
        if not torch.equal(_words(got), _words(want)):
            raise AssertionError(f"K9 on {row_bytes}-byte rows: not bitwise "
                                 "equal")
        ms = _time_ms(lambda: pul_filter(wide, 0.25))
        key = f"K9 bit-vector, tiles of 64 B of each {row_bytes}-byte row"
        out[key] = ms
        print(f"[probe] {key}: {ms:.4f} ms")
    print("[probe] " + json.dumps(out))
    return out


def split_sweep():
    """One-off, not a phase of the smoke: K1 at the mixed decode case with
    the split count and the ring distance forced (one split, the 63-page row
    in one block, and the plan's 8), and the device time of its two kernels
    under torch.profiler at the plan's split count, at one split and at 64
    (a page a split). Prints [split] lines."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    c = _kernel_case(gen, dev, [0, 7, 16, 1000, 513, 250, 64, 999])
    kw = dict(scale=1.0 / math.sqrt(HD), softcap=None, window=None)
    layer = 5

    def k1(cfg, n_split=None):
        return PA.pul_paged_sweep_decode_attention(
            c["q"], c["kp"], c["vp"], layer, c["pt"], c["lens"], c["kn"],
            c["vn"], c["frames"], c["offs"], cfg=cfg, n_split=n_split, **kw)

    print(_smi("name,power.limit"))
    out = {}
    for n_split in (1, 8):
        for d in (1, 2, 4, 8, 16):
            for strategy in IssueStrategy:
                cfg = PULConfig(distance=d, strategy=strategy)
                plan = PA.paged_split_plan(cfg, B=8, K=KV, G=H // KV, P=P,
                                           hd=HD, n_pages=c["pt"].shape[1],
                                           n_split=n_split)
                ms = _time_ms(lambda: k1(cfg, n_split))
                key = f"n_split {n_split} d={d} {strategy.name}"
                out[key] = ms
                print(f"[split] {key}: K1 {ms:.4f} ms (ring d={plan.distance}"
                      f", {plan.slots} slots)")
    cfg = PULConfig(distance=engine_distance())
    for n_split in (None, 1, 64):
        for _ in range(3):
            k1(cfg, n_split)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                k1(cfg, n_split)
            torch.cuda.synchronize()
        for e in prof.key_averages():
            dev_us = e.device_time
            if e.count and dev_us and "kernel" in e.key:
                print(f"[split] profiler, n_split {n_split or 'planned'}: "
                      f"{e.key[:60]}: {e.count} calls, {dev_us:.2f} us each "
                      "on the device")
    print("[split] " + json.dumps(out))
    return out


def mla_split_sweep():
    """One-off, not a phase of the smoke: K3 at the mixed decode case with
    the split count and the ring distance forced (one split, the 63-page
    row in one block, and the plan's 8), and the device time of its split
    and merge kernels under torch.profiler at the plan's split count, at
    one split and at 64 (a page a split). Prints [mla-split] lines."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    c = _mla_case(gen, dev, [0, 7, 16, 1000, 513, 250, 64, 999])
    scale = 1.0 / math.sqrt(MLA_QK)

    def k3(cfg, n_split=None):
        return PA.pul_paged_sweep_mla_decode_attention(
            c["qa"], c["qr"], c["cp"], c["rp"], 2, c["pt"], c["lens"],
            c["cn"], c["rn"], c["frames"], c["offs"], scale=scale, cfg=cfg,
            n_split=n_split)

    print(_smi("name,power.limit"))
    out = {}
    for n_split in (1, 8):
        for d in (1, 2, 4, 8):
            for strategy in IssueStrategy:
                cfg = PULConfig(distance=d, strategy=strategy)
                plan = _mla_split_plan(c, cfg, n_split)
                ms = _time_ms(lambda: k3(cfg, n_split))
                key = f"n_split {n_split} d={d} {strategy.name}"
                out[key] = ms
                print(f"[mla-split] {key}: K3 {ms:.4f} ms (ring d="
                      f"{plan.distance}, {plan.slots} slots)")
    cfg = PULConfig(distance=engine_distance(MLA_LAYERS * (KVR + DR), 1))
    for n_split in (None, 1, 64):
        for _ in range(3):
            k3(cfg, n_split)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                k3(cfg, n_split)
            torch.cuda.synchronize()
        for e in prof.key_averages():
            dev_us = e.device_time
            if e.count and dev_us and "kernel" in e.key:
                print(f"[mla-split] profiler, n_split {n_split or 'planned'}: "
                      f"{e.key[:60]}: {e.count} calls, {dev_us:.2f} us each "
                      "on the device")
    print("[mla-split] " + json.dumps(out))
    return out


def decode_sweep():
    """One-off, not a phase of the smoke: K6 at the smoke's lengths with the
    segment size forced (16, 64 and 256 chunks, and the card's balanced
    cut) and the ring distance forced (d 1, 2, 4, 8) in both issue orders,
    each checked against the plain version first; then the device time of
    its split and merge kernels under torch.profiler at the balanced cut,
    at 16 and at 256 chunks a segment. Prints [decode] lines."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    q, k, v, lens = _decode_inputs(gen, dev)
    want = decode_attention_kernel_ref(q, k, v, lens)
    print(_smi("name,power.limit"))
    out = {}
    for seg in (None, 16, 64, 256):
        for d in (1, 2, 4, 8):
            for strategy in IssueStrategy:
                cfg = PULConfig(distance=d, strategy=strategy)
                plan = _decode_plan(dev, cfg, seg)
                _dense_check(pul_decode_attention(q, k, v, lens, cfg=cfg,
                                                  seg_chunks=seg), want,
                             f"K6 seg {seg} d={d} {strategy.name}")
                ms = _time_ms(lambda: pul_decode_attention(
                    q, k, v, lens, cfg=cfg, seg_chunks=seg))
                key = f"seg {seg or 'balanced'} d={d} {strategy.name}"
                out[key] = ms
                print(f"[decode] {key}: K6 {ms:.4f} ms (ring d="
                      f"{plan.distance}, {plan.slots} slots, "
                      f"{plan.blocks_per_sm} blocks/SM)")
    for seg in (None, 16, 256):
        for _ in range(3):
            pul_decode_attention(q, k, v, lens, seg_chunks=seg)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                pul_decode_attention(q, k, v, lens, seg_chunks=seg)
            torch.cuda.synchronize()
        for e in prof.key_averages():
            dev_us = e.device_time
            if e.count and dev_us and "kernel" in e.key:
                print(f"[decode] profiler, seg {seg or 'balanced'}: "
                      f"{e.key[:60]}: {e.count} calls, {dev_us:.2f} us each "
                      "on the device")
    print("[decode] " + json.dumps(out))
    return out


def chunk_sweep():
    """One-off, not a phase of the smoke: K5 at the two serving page
    geometries and the engine's distance, with chunks of 8, 16 and 32 KB
    (pul_gather.CHUNK_BYTES), BATCH with the store's one slot; and at 32
    KB, SEQUENTIAL, and BATCH with no slot or two for stores still reading
    (PULConfig.unload_distance 0, 2). index_select is timed in the same
    loop (before and after the kernel); each point is checked bitwise
    first. Prints one [chunks] line per point."""
    gather_mod = importlib.import_module("repro_torch.kernels.pul_gather")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    n_pages = MAX_SEQ // P
    NF = SLOTS * n_pages + 4
    default = gather_mod.CHUNK_BYTES
    print(_smi("name,power.limit"))
    out = {}
    for label, F, gqa in (("qwen3", 2 * L * KV * HD, H // KV),
                          ("deepseek", MLA_LAYERS * (KVR + DR), 1)):
        store = torch.randn((NF, P, F), generator=gen, device=dev,
                            dtype=torch.bfloat16)
        pt = torch.randperm(NF, generator=gen, device=dev)[
            :SLOTS * n_pages].reshape(SLOTS, n_pages).to(torch.int32)
        flat = pt.reshape(-1)
        want = page_gather_ref(store, pt)
        for chunk, strategy, lag in (
                [(c, IssueStrategy.BATCH, 1) for c in (8192, 16384, 32768)]
                + [(32768, IssueStrategy.SEQUENTIAL, 1),
                   (32768, IssueStrategy.BATCH, 0),
                   (32768, IssueStrategy.BATCH, 2)]):
            gather_mod.CHUNK_BYTES = chunk
            cfg = PULConfig(distance=engine_distance(F, gqa),
                            strategy=strategy, unload_distance=lag)
            plan = gather_bulk_plan(cfg, rows_per_req=P, row_bytes=F * 2)
            if not torch.equal(pul_page_gather(store, pt, cfg=cfg), want):
                raise AssertionError(f"{label} chunk {chunk}: K5 differs")
            lib0 = _time_ms(lambda: torch.index_select(store, 0, flat))
            ms = _time_ms(lambda: pul_page_gather(store, pt, cfg=cfg))
            lib1 = _time_ms(lambda: torch.index_select(store, 0, flat))
            key = (f"{label} chunk {chunk} {strategy.name} "
                   f"unload_distance {lag}")
            out[key] = ms
            print(f"[chunks] {key}: K5 {ms:.4f} ms, index_select "
                  f"{lib0:.4f} / {lib1:.4f} ms (d={plan.distance}, "
                  f"{plan.slots} slots, {plan.smem_bytes} B a block)")
        del store, want
        torch.cuda.empty_cache()
    gather_mod.CHUNK_BYTES = default
    print("[chunks] " + json.dumps(out))
    return out


def _serve_two_paths(cfg, params, first, second, device="cuda"):
    """The request script through two decode paths whose token streams and
    bytes_hot_written must be bitwise equal. Returns (stats of each, the
    first path's tokens and top-2 gaps)."""
    warm_up(cfg, params, device, paths=(first, second))
    out1, s1, gaps = phase_serving(cfg, params, path=first, device=device)
    out2, s2, _ = phase_serving(cfg, params, path=second, device=device)
    tag = _tag(cfg, first)
    if out1 != out2:
        raise AssertionError(f"{cfg.name}: {s2['path']} tokens differ from "
                             f"the {s1['path']} tokens")
    if s1["bytes_hot_written"] != s2["bytes_hot_written"]:
        raise AssertionError(f"{cfg.name}: bytes_hot_written differs between "
                             "the paths")
    print(f"{tag} {s2['path']} tokens == {s1['path']} tokens bitwise over "
          f"{sum(len(v) for v in out1.values())} tokens")
    return s1, s2, out1, gaps


def _serve_captured_and_eager(cfg, params, device="cuda",
                              eager=("sweep", "per-layer")):
    """The request script on the sweep and per-layer paths, first replayed
    from their captured CUDA graphs (the engine's default) and then, for
    the paths in `eager`, run eagerly (capture_decode=False): every token
    stream and bytes_hot_written bitwise equal. Prints each path's decode
    tick median and tokens/s, captured beside eager. Returns (stats of the
    captured sweep and per-layer runs, the sweep's tokens and top-2
    gaps)."""
    s1, s2, out, gaps = _serve_two_paths(cfg, params, "sweep", "per-layer",
                                         device)
    tag = _tag(cfg, "sweep")
    warm_up(cfg, params, device, paths=tuple(f"{p}-eager" for p in eager))
    ticks = {}
    for path, cap in (("sweep", s1), ("per-layer", s2)):
        if path not in eager:
            continue
        eager_out, e, _ = phase_serving(cfg, params, path=f"{path}-eager",
                                        device=device)
        if (eager_out != out
                or e["bytes_hot_written"] != cap["bytes_hot_written"]):
            raise AssertionError(f"{cfg.name}: the eager {path} step's "
                                 "tokens differ from the captured step's")
        ticks[cap["path"]] = {
            "captured_decode_tick_ms_median": cap["decode_tick_ms_median"],
            "eager_decode_tick_ms_median": e["decode_tick_ms_median"],
            "captured_tokens_per_s": cap["tokens_per_s"],
            "eager_tokens_per_s": e["tokens_per_s"]}
    print(f"{tag} captured tokens == eager tokens ({', '.join(eager)}) "
          f"bitwise over {sum(len(v) for v in out.values())} tokens")
    print(f"{tag} captured vs eager " + json.dumps(ticks))
    return s1, s2, out, gaps


def _one_step_logits(cfg, params, path, device):
    """A fresh engine admits the script's first 8 requests; the logits of
    its first decode step, by request."""
    eng = _engine(cfg, params, path, device)
    for r in _requests(cfg.vocab_size)[:SLOTS]:
        eng.submit(r)
    eng.step()                  # prefill of all 8, then one decode step
    if sorted(eng.decode_logits) != list(range(SLOTS)):
        raise AssertionError(f"{path}: the first tick decoded "
                             f"{sorted(eng.decode_logits)}")
    return eng.decode_logits


def phase_serving_assembly(cfg, params, sweep_out, sweep_gaps, device="cuda"):
    """The request script on the assembly path through K5, then through
    plain indexing (bitwise-equal tokens); one decode step's logits against
    the sweep kernel's (K1; K3 for MLA) within 2e-2 of max |logits|, the
    CPU model tests' bound; and where the assembly stream first leaves the
    sweep's, with the sweep's top-2 gap there."""
    s_k5, s_plain, out, _ = _serve_two_paths(cfg, params, "assembly",
                                             "assembly-plain", device)
    tag = _tag(cfg, "assembly")
    asm = _one_step_logits(cfg, params, "assembly", device)
    ker = _one_step_logits(cfg, params, "sweep", device)
    err = max(float(np.abs(asm[r] - ker[r]).max()) for r in ker)
    limit = 2e-2 * max(float(np.abs(ker[r]).max()) for r in ker)
    if err > limit:
        raise AssertionError(f"{cfg.name}: assembly logits differ from the "
                             f"sweep kernel's by {err} > {limit}")
    print(f"{tag} one decode step, 8 requests: max |assembly - "
          f"{_path_kernel(cfg, 'sweep')[0].upper()}| logits {err:.4e} "
          f"(limit {limit:.4e} = 2e-2 x max |logits|)")
    _divergence(tag, sweep_out, sweep_gaps, out)
    return s_k5, s_plain


def _divergence(tag, sweep_out, sweep_gaps, out):
    """Where the assembly stream first leaves the sweep's, per request, with
    the sweep's top-2 gap there (bf16 near-ties flip under another
    summation order); fails on a divergence that is not a near-tie."""
    firsts = paged_decode.first_divergences(sweep_out, sweep_gaps, out)
    shown = {rid: v and (v[0], round(v[1], 5), round(v[2], 3))
             for rid, v in firsts.items()}
    same = sum(1 for v in firsts.values() if v is None)
    print(f"{tag} assembly vs sweep tokens: {same} of {len(firsts)} requests "
          f"identical; first divergence per request (index, the sweep's "
          f"top-2 gap there, its max |logits|): {json.dumps(shown)}")
    bad = paged_decode.past_near_ties(firsts)
    if bad:
        raise AssertionError(f"{tag} assembly left the sweep past a bf16 "
                             f"near-tie ({paged_decode.NEAR_TIE} x max "
                             f"|logits|): {bad}")


class _CheckedDense(ServingEngine):
    """The dense engine with every emitted logit row checked for
    finiteness."""

    def _emit(self, logits):
        if not np.isfinite(logits).all():
            raise AssertionError("non-finite logits")
        super()._emit(logits)


class _LastDense(_CheckedDense):
    """The checked dense engine keeping each slot's last emitted logits, by
    request."""

    def _emit(self, logits):
        self.last = {r.rid: logits[i].copy()
                     for i, r in enumerate(self.slot_req) if r is not None}
        super()._emit(logits)


def _same_state(cfg, params, tag, device, geometry, n_tokens):
    """One decode step on one state three ways: every slot of `geometry`
    admitted at once with a prompt of n_tokens (random, seed 2), prefilled
    at one bucket and decoded once at position n_tokens, by the sweep
    kernel (K1), by the assembly path (K5, then the dense decode, whose
    local layers mask the window) and by the dense ServingEngine (a
    bucket of n_tokens, so no padding; its local layers keep rings of
    min(window, max_seq) rows). The assembly and dense logits must lie
    within 2e-2 x max |logits| of K1's."""
    slots, max_seq, _ = geometry
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, cfg.vocab_size, n_tokens).tolist()
               for _ in range(slots)]
    logits = {}
    for path in ("sweep", "assembly"):
        eng = _geometry_engine(cfg, params, path, device, geometry)
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=2))
        eng.step()               # one prefill of every slot, one decode step
        if sorted(eng.decode_logits) != list(range(slots)):
            raise AssertionError(f"{path}: the first tick decoded "
                                 f"{sorted(eng.decode_logits)}")
        logits[path] = eng.decode_logits
        del eng
        torch.cuda.empty_cache()
    dense = _LastDense(cfg, params, EngineConfig(
        batch_slots=slots, max_seq=max_seq, prefill_bucket=n_tokens,
        device=device))
    for i, p in enumerate(prompts):
        dense.submit(Request(rid=i, prompt=p, max_new_tokens=2))
    dense.step()
    logits["dense"] = dense.last
    del dense
    torch.cuda.empty_cache()
    k1 = logits["sweep"]
    limit = 2e-2 * max(float(np.abs(v).max()) for v in k1.values())
    errs = {path: max(float(np.abs(logits[path][r] - k1[r]).max())
                      for r in k1) for path in ("assembly", "dense")}
    bad = {k: v for k, v in errs.items() if not v <= limit}
    if bad:
        raise AssertionError(f"{cfg.name} at {n_tokens} tokens: {bad} past "
                             f"{limit} (2e-2 x max |K1 logits|)")
    print(f"{tag} one decode step at position {n_tokens}, {slots} slots of "
          f"{max_seq}: max |logits - K1's|: assembly {errs['assembly']:.4e}, "
          f"dense engine {errs['dense']:.4e} (limit {limit:.4e} = 2e-2 x max "
          "|logits|)")
    return errs


def phase_serving_dense(cfg, params, device="cuda"):
    """The script's 12 requests on the dense ServingEngine (left-padded
    512-token bucket prefill, whole-batch re-prefill on admission)."""
    eng = _CheckedDense(cfg, params, EngineConfig(
        batch_slots=SLOTS, max_seq=MAX_SEQ, prefill_bucket=512,
        device=device))
    for r in _requests(cfg.vocab_size):
        eng.submit(r)
    for k in PA.LAUNCHES:
        PA.LAUNCHES[k] = 0
    _sync(device)
    t0 = time.perf_counter()
    ticks = 0
    while eng.queue or any(r is not None for r in eng.slot_req):
        eng.step()
        ticks += 1
    out = {rid: r.out_tokens for rid, r in eng.requests.items()}
    _sync(device)
    wall = time.perf_counter() - t0
    if sorted(out) != list(range(12)) or any(len(v) != 24 for v in out.values()):
        raise AssertionError(f"dense engine: not every request finished: "
                             f"{ {k: len(v) for k, v in out.items()} }")
    if any(PA.LAUNCHES.values()):
        raise AssertionError(f"the dense engine launched {PA.LAUNCHES}")
    tokens = sum(len(v) for v in out.values())
    stats = {"model": cfg.name, "ticks": ticks, "tokens": tokens,
             "wall_s": wall, "tokens_per_s": tokens / wall,
             "ms_per_tick": wall / ticks * 1e3}
    print("[serving-dense] " + json.dumps(stats))
    del eng
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return stats


def _launched(key, want, what):
    """PA.LAUNCHES since it was last zeroed: `key` exactly `want` times and
    no other paged kernel at all."""
    got = dict(PA.LAUNCHES)
    others = [k for k, n in got.items() if n and k != key]
    if got.get(key, 0) != want or others:
        raise AssertionError(f"{what}: launches {got}, expected {key} x "
                             f"{want} and nothing else")
    return got[key]


def phase_serving_bench(cfg, params, device="cuda"):
    """The port's serving benchmarks at the model's width (full-width
    qwen3-1.7b in the smoke), through their functions on the params
    already on the card:

      * serving_slo's three policies on the captured sweep (K1): the
        contract and the gate against the port's own baseline
        (``benchmarks/baselines/serving.json``); ticks, TTFT p50/p99 in
        ticks, tokens/s and the tick medians per policy;
      * roofline --serving on the captured sweep, gated against
        ``baselines/roofline_serving.json``, each tier's fraction;
      * paged_decode: the assembly path (K5) and the kernel-true sweep (K1)
        eagerly and the sweep captured; tokens agree up to the first bf16
        near-tie, captured == eager bitwise;
      * the serving_slo workload (slo-edf) with shadow_check on the
        captured sweep, SHADOW_TURNS runs in turns with as many unchecked: no
        violation, the decode tick medians side by side;
      * one planted corruption of a shadow-checked engine's trace, which the
        next tick must reject with LifecycleViolationError."""
    from repro_torch.analysis import EventKind, LifecycleViolationError
    from repro_torch.benchmarks import roofline, serving_slo

    L = cfg.num_layers
    n_params = common.n_params_of(params)
    for k in PA.LAUNCHES:
        PA.LAUNCHES[k] = 0
    policies = serving_slo.run_all(cfg, params, 64, path="sweep",
                                   device=device, n_params=n_params)
    k1 = _launched("k1", L * sum(p["decode_steps"]
                                 for p in policies.values()), "serving_slo")
    gate = serving_slo.evaluate_gate(
        policies, common.default_baseline("serving", reduced=False))
    summary = {pol: {k: p[k] for k in (
        "ticks", "ttft_p50_ticks", "ttft_p99_ticks", "tokens_per_sec",
        "tick_ms_median", "decode_tick_ms_median", "decode_ticks",
        "prefill_tick_ms_median", "prefill_ticks", "preemptions",
        "page_faults", "evictions")} | {
            "hp_ttft_ticks": p["high_priority"]["ttft_ticks"],
            "hp_violations": p["high_priority"]["violations"],
            "hot_bw_fraction": p["roofline"]["tiers"]["hot"]["bw_fraction"],
            "cold_bw_fraction": p["roofline"]["tiers"]["cold"]["bw_fraction"]}
        for pol, p in policies.items()}
    print(f"[serving-bench] serving_slo (K1 launches {k1}, {L} a decode "
          "step, under replay) " + json.dumps(summary))
    for c in gate["checks"]:
        print(f"[serving-bench] serving_slo gate {c['metric']}: "
              f"{c['measured']:.6g} vs baseline {c['baseline']} (threshold "
              f"{c['threshold']}x) [{'PASS' if c['pass'] else 'FAIL'}]")
    failures = serving_slo.contract_failures(policies)
    if failures or not gate["pass"]:
        raise AssertionError(f"serving_slo: contract {failures}, gate "
                             f"{'PASS' if gate['pass'] else 'FAIL'}")

    for k in PA.LAUNCHES:
        PA.LAUNCHES[k] = 0
    roof = roofline.run_serving(cfg, params, path="sweep", device=device)
    rgate = roofline.evaluate_serving_gate(
        roof, common.default_baseline("roofline_serving", reduced=False))
    roofline.print_serving(roof, rgate)
    _launched("k1", L * roof["decode_steps"], "roofline --serving")
    if not rgate["pass"]:
        raise AssertionError("roofline --serving: gate FAIL")

    for k in PA.LAUNCHES:
        PA.LAUNCHES[k] = 0
    decode = paged_decode.compare(cfg, params, device=device)
    print("[serving-bench] paged_decode " + json.dumps(decode["paths"]))
    steps = {name: p["decode_steps"] for name, p in decode["paths"].items()}
    want = {"k5": steps["assemble-then-attend"],
            "k1": L * (steps["kernel-true"] + steps["kernel-true (captured)"])}
    got = {k: n for k, n in PA.LAUNCHES.items() if n}
    if got != want:
        raise AssertionError(f"paged_decode: launches {got}, expected {want}")

    # the slo-edf run with shadow_check, in turns with the unchecked run
    # (checked first, then unchecked first), SHADOW_TURNS of each
    runs = {True: [], False: []}
    for k in PA.LAUNCHES:
        PA.LAUNCHES[k] = 0
    for turn in range(SHADOW_TURNS):
        for check in ((True, False) if turn % 2 == 0 else (False, True)):
            runs[check].append(serving_slo.run_policy(
                cfg, params, "slo-edf", 64, path="sweep", device=device,
                n_params=n_params, shadow_check=check))
    _launched("k1", L * sum(r["decode_steps"] for rs in runs.values()
                            for r in rs), "shadow-checked serving_slo")
    plain = policies["slo-edf"]
    keys = ("ticks", "tokens_emitted", "page_faults", "evictions",
            "high_priority")
    if any(r[k] != plain[k] for rs in runs.values() for r in rs for k in keys):
        raise AssertionError("a shadow-checked or repeated run's counters "
                             "differ from the first unchecked run's")
    ticks = {("checked" if check else "unchecked"):
             [round(r["decode_tick_ms_median"], 4) for r in rs]
             for check, rs in runs.items()}
    med = {k: statistics.median(v) for k, v in ticks.items()}
    # the gap is resolved only where the two sides do not overlap
    if min(ticks["checked"]) > max(ticks["unchecked"]):
        verdict = "resolved: every checked run slower than every unchecked"
    elif max(ticks["checked"]) < min(ticks["unchecked"]):
        verdict = "resolved: every checked run faster than every unchecked"
    else:
        verdict = "NOT resolved: the two sides' runs overlap"
    spread = {k: round(max(v) - min(v), 4) for k, v in ticks.items()}
    print(f"[serving-bench] shadow_check (slo-edf, captured sweep): 0 "
          f"violations over {SHADOW_TURNS} x {plain['ticks']} ticks; decode "
          f"tick medians {json.dumps(ticks)} ms (in turns); median of "
          f"medians {med['checked']:.4f} checked vs {med['unchecked']:.4f} "
          f"ms unchecked, {med['checked'] - med['unchecked']:+.4f} ms a "
          f"tick; spread {json.dumps(spread)} ms; {verdict}")

    eng = PagedServingEngine(cfg, params, serving_slo.engine_config(
        "fcfs", path="sweep", device=device, shadow_check=True))
    eng.submit(Request(rid=0, prompt=list(range(1, 7)), max_new_tokens=8))
    eng.step()
    eng.step()
    eng.pool.trace.emit(0, EventKind.UNREF, pid=999, refcount=-1)
    try:
        eng.step()
    except LifecycleViolationError as e:
        if "refcount-underflow" not in str(e):
            raise
        print("[serving-bench] planted corruption (an unref of an unknown "
              "page) rejected at the next tick: "
              f"{str(e).splitlines()[1].strip()}")
    else:
        raise AssertionError("shadow_check let a planted corruption pass")
    return summary, roof, decode


def _timed(label, fn, *args, **kw):
    """fn(*args, **kw), then one line: its seconds and the peak allocated
    device memory while it ran."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    print(f"[phase] {label}: {time.perf_counter() - t0:.1f} s, peak "
          f"allocated {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    return out


class PastWindow(NamedTuple):
    """A model's phase past its window: its name, geometry (slots,
    max_seq, buckets), prompt lengths, and the prompt length of its
    same-state check."""
    name: str
    geometry: Tuple[int, int, Tuple[int, ...]]
    prompts: Tuple[int, ...]
    same_state: int


#: the local/global and wide-GQA models served at full width, with the
#: phase that serves past the window where the model has one: qwen2.5-32b
#: (a group of 5, qkv bias), gemma2-27b (local/global, window 4096, softcap
#: 50, sandwich norms: 2 slots of 6144, decode positions to 5015) and
#: gemma3-12b (5 local : 1 global, window 1024, hd 256, local rope theta:
#: the long script, every decode position past the window)
LOCAL_MODELS = {
    "qwen2.5-32b": None,
    "gemma2-27b": PastWindow("serving-gemma2-window", WINDOW_GEOMETRY,
                             WINDOW_PROMPTS, 5000),
    "gemma3-12b": PastWindow("serving-gemma3-long", LONG, LONG_PROMPTS,
                             2048),
}
#: the rest of the attention zoo, served through K1/K2 without a window:
#: grok-1 (MoE through the einsum dispatch, a group of 6, softcap 30; depth
#: cut to GROK_LAYERS), internvl2-2b (qwen3's attention widths, a vocab of
#: 92,553) and musicgen-large (MHA at hd 64, sinusoidal positions, the
#: plain GELU MLP), full width
ZOO_MODELS = {GROK: None, "internvl2-2b": None, "musicgen-large": None}
#: every model served by phase_model, in the smoke's order
SERVED_MODELS = {**LOCAL_MODELS, **ZOO_MODELS}


def phase_model(arch, device="cuda"):
    """One model of SERVED_MODELS at the smoke's configuration (full width;
    grok-1's depth cut), random weights from seed 0, loaded alone and freed
    at the end: the request script on the sweep and per-layer paths
    captured, then the sweep eagerly (three token streams
    bitwise equal, K1/K2 launches one per layer and decode step), once on
    the assembly path through K5, and one decode step of the assembly path
    and of the dense ServingEngine held to K1's on one state. A model with
    a window then serves its PastWindow phase: the streamed prefill
    attention with the model's window and softcap held to the dense one at
    T = S = the phase's max_seq (before the weights load), the script
    monolithic and chunked, and the same-state check there. Then the
    captured K1 step's profile. Every phase prints its seconds and peak
    memory."""
    cfg = smoke_config(arch)
    tag = f"[{TAGS[arch]}]"
    past = SERVED_MODELS[arch]
    if past:
        _timed(f"{past.name} streamed attention", _streamed_vs_dense,
               device, T=past.geometry[1], heads=cfg.num_heads,
               kv=cfg.num_kv_heads, hd=cfg.head_dim, softcap=cfg.attn_softcap,
               window=cfg.sliding_window, tag=f"[{past.name}]")
    t1 = time.perf_counter()
    params = _timed(f"{TAGS[arch]} init", init_params, cfg, seed=0,
                    device=device)
    weights = sum(t.numel() * t.element_size() for _, t in flatten(params))
    print(f"{tag} {cfg.name}: {cfg.num_layers} of "
          f"{get_config(arch).num_layers} layers, pattern {cfg.pattern}, "
          f"window {cfg.sliding_window}, "
          f"moe {cfg.moe_backend if cfg.num_experts else None}, "
          f"{weights / 1e9:.2f} GB of weights, init "
          f"{time.perf_counter() - t1:.1f} s")
    s1, s2, out, gaps = _timed(f"{TAGS[arch]} captured and eager",
                               _serve_captured_and_eager, cfg, params, device,
                               eager=("sweep",))
    asm, _, _ = _timed(f"{TAGS[arch]}-assembly", phase_serving, cfg, params,
                       path="assembly", device=device)
    _divergence(_tag(cfg, "assembly"), out, gaps, asm)
    _timed(f"{TAGS[arch]} same state", _same_state, cfg, params, tag, device,
           (SLOTS, MAX_SEQ, SERVE_BUCKETS), 512)
    if past:
        _timed(past.name, _long_runs, cfg, params, f"[{past.name}]", device,
               past.geometry, past.prompts)
        _timed(f"{past.name} same state", _same_state, cfg, params,
               f"[{past.name}]", device, past.geometry, past.same_state)
    _timed(f"{TAGS[arch]} profile", profile_decode, arch, "sweep",
           params=params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
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
    phase_kernels_served()
    kern.update(phase_kernels_mla())
    gather = phase_kernels_gather()
    kern["k5"] = gather["qwen3"]
    micro, k10_launches, table = phase_kernels_micro()
    kern.update(micro)
    paper_launches = phase_paper(table)
    del table
    torch.cuda.empty_cache()
    attn, attn_launches, _ = phase_kernels_attn()
    kern.update(attn)
    torch.cuda.empty_cache()
    print(f"[done] kernels {time.perf_counter() - t0:.1f} s")

    cfg = smoke_config("qwen3-1.7b")
    params = init_params(cfg, seed=0, device="cuda")
    s1, s2, sweep_out, sweep_gaps = _serve_captured_and_eager(cfg, params)
    stats = {"k1": s1, "k2": s2, "k10": {"launches": k10_launches},
             **{k: {"launches": n} for k, n in attn_launches.items()},
             **{k: {"launches": n} for k, n in paper_launches.items()}}
    stats["k5"], _ = phase_serving_assembly(cfg, params, sweep_out, sweep_gaps)
    phase_serving_dense(cfg, params)
    _timed("serving-bench", phase_serving_bench, cfg, params)
    phase_serving_long(cfg, params)
    profile_decode(cfg.name, "sweep", params=params)
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
    s3, s4, sweep_out, sweep_gaps = _serve_captured_and_eager(cfg, params)
    stats.update(k3=s3, k4=s4)
    phase_serving_assembly(cfg, params, sweep_out, sweep_gaps)
    phase_serving_long(cfg, params)
    profile_decode(cfg.name, "sweep", params=params)
    print(f"[serving-mla] peak allocated "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[done] serving-mla {time.perf_counter() - t0:.1f} s")

    for arch in SERVED_MODELS:
        phase_model(arch)
        print(f"[done] {TAGS[arch]} {time.perf_counter() - t0:.1f} s")

    rows = []
    for key, name, source, replaces in (
            ("k1", "pul_paged_sweep_decode_attention", "pul_paged_decode",
             "pul_attention.py:406"),
            ("k2", "pul_paged_decode_attention", "pul_paged_decode",
             "pul_attention.py:152"),
            ("k3", "pul_paged_sweep_mla_decode_attention",
             "pul_paged_mla_decode", "pul_attention.py:553"),
            ("k4", "pul_paged_mla_decode_attention", "pul_paged_mla_decode",
             "pul_attention.py:272"),
            ("k5", "pul_gather", "pul_gather", "pul_gather.py:60"),
            ("k6", "pul_decode_attention", "pul_dense_attention",
             "pul_decode.py:71"),
            ("k7", "pul_attention", "pul_dense_attention",
             "pul_attention.py:620"),
            ("k8", "pul_sum", "pul_sum", "pul_sum.py:40"),
            ("k9", "pul_filter", "pul_filter", "pul_filter.py:73"),
            ("k10", "pul_matmul", "pul_matmul", "pul_matmul.py:62")):
        rows.append({"name": name, "route": "cuda",
                     "source": f"src/repro_torch/csrc/{source}.cu",
                     "replaces": f"src/repro/kernels/{replaces}",
                     "launches": stats[key]["launches"],
                     **{k: kern[key][k] for k in (
                         "max_abs_err", "ms", "plain_ms", "bound_ms",
                         "bound_by")},
                     "library_ms": kern[key].get("library_ms"),
                     # which body ran: "wgmma" or "mma.sync" on the tensor
                     # cores, "split-kv mma.sync" (K3/K4's split and merge
                     # kernels, the products on the tensor cores), "split-kv"
                     # (K1/K2's and K6's, on the CUDA cores) or "fma" on the
                     # CUDA cores, "cp.async.bulk" (K5's TMA copies),
                     # "cp.async.bulk.tensor" (K9's TMA tiles)
                     "body": kern[key].get("body", "fma")})
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
