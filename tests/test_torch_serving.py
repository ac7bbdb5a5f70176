"""Port serving stack (repro_torch.serving) vs the reference, reduced qwen3
and reduced deepseek-v2 (MLA + MoE: the K3/K4 paths, an unscanned dense
layer's planes).

The same request script runs through the reference's PagedServingEngine
(kernel-true fused sweep, Pallas in interpret mode) and the port's (plain
kernel versions on the CPU), with the reference's memory tiers handed to the
port's page config. Deterministic counters must be equal; greedy tokens must
agree up to the first step where the reference's top-2 logit gap falls below
the logits tolerance (2e-2 * max|logits|, see test_torch_models), since
bf16 near-ties flip under a different summation order. Inside the port the
sweep and per-layer paths must agree bitwise.
"""
import dataclasses
import io
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core import HBM, REMOTE_HBM, TPU_V5E_VPU
from repro.core.dma import DMAEngine as RefDMAEngine
from repro.core.dma import KVPageWorkload as RefWorkload
from repro.core.dma import run_kv_page_workload as ref_run_workload
from repro.core.planner import plan_kv_page_stream as ref_plan
from repro.models import build_model as ref_build_model
from repro.serving import PackedKVLayout as RefLayout
from repro.serving import PagedEngineConfig as RefEngineConfig
from repro.serving import PagedServingEngine as RefEngine
from repro.serving import Request as RefRequest
from repro_torch.configs import get_config
from repro_torch.core import DMAEngine, KVPageWorkload, MemoryTier, PEModel
from repro_torch.core import plan_kv_page_stream, run_kv_page_workload
from repro_torch.launch import serve
from repro_torch.models import init_params
from repro_torch.models.bridge import params_from_reference
from repro_torch.serving import (
    KVPagePool,
    PackedKVLayout,
    PageConfig,
    PagedEngineConfig,
    PagedServingEngine,
    PoolMetrics,
    Request,
    ServingConfig,
)

ARCH = "qwen3-1.7b"
DEEPSEEK = "deepseek-v2-236b"
REL = 2e-2
# the reference's page-pool tiers, in the port's types
TIERS = dict(fast_tier=MemoryTier(**dataclasses.asdict(HBM)),
             slow_tier=MemoryTier(**dataclasses.asdict(REMOTE_HBM)),
             pe=PEModel(**dataclasses.asdict(TPU_V5E_VPU)))
BASE = dict(batch_slots=2, max_seq=64, page_tokens=8,
            prefill_buckets=(8, 16, 32), use_paged_kernel=True)


def _models(arch):
    ref_cfg = ref_get_config(arch).reduced()
    ref_params = ref_build_model(
        dataclasses.replace(ref_cfg, paged_kv=True)).init(jax.random.PRNGKey(0))
    flat = {"/".join(str(getattr(p, "key", p)) for p in path):
            np.asarray(leaf.astype(jnp.float32))
            for path, leaf in jax.tree_util.tree_flatten_with_path(ref_params)[0]}
    cfg = get_config(arch).reduced()
    return ref_cfg, ref_params, cfg, params_from_reference(flat, cfg,
                                                           device="cpu")


@pytest.fixture(scope="module")
def models():
    return _models(ARCH)


@pytest.fixture(scope="module")
def ds_models():
    return _models(DEEPSEEK)


class _RefRecorder(RefEngine):
    """Reference engine that records each emitted token's top-2 gap."""

    def _emit_token(self, slot, logits):
        top = np.sort(np.asarray(logits, np.float64))[-2:]
        self.gaps.setdefault(self.slot_req[slot].rid, []).append(
            top[1] - top[0] < REL * np.abs(logits).max())
        super()._emit_token(slot, logits)


def _script_fcfs(eng, Req):
    """Prefix sharing (r0/r1 share a page in bucket 16), first-token replay
    (r2 repeats r0's page-aligned prompt while r0 still runs), and a
    preempt/resume round trip through the cold tier."""
    rng = np.random.default_rng(5)
    p0 = rng.integers(1, 256, size=16).tolist()
    p1 = p0[:8] + rng.integers(1, 256, size=4).tolist()
    p3 = rng.integers(1, 256, size=20).tolist()
    eng.submit(Req(rid=0, prompt=list(p0), max_new_tokens=10))
    eng.submit(Req(rid=1, prompt=p1, max_new_tokens=3))
    eng.submit(Req(rid=2, prompt=list(p0), max_new_tokens=4))
    eng.submit(Req(rid=3, prompt=p3, max_new_tokens=5))
    for _ in range(2):
        eng.step()
    eng.preempt(0)
    for _ in range(2):
        eng.step()
    eng.resume(0)
    return eng.run()


def _script_priority_chunked(eng, Req):
    """A high-priority arrival preempts a slot mid-chunked-prefill; the
    victim resumes from the cold tier and finishes its ladder."""
    rng = np.random.default_rng(10)
    eng.submit(Req(rid=0, prompt=rng.integers(1, 256, size=20).tolist(),
                   max_new_tokens=6, priority=0))
    eng.step()
    eng.submit(Req(rid=1, prompt=rng.integers(1, 256, size=4).tolist(),
                   max_new_tokens=3, priority=2))
    return eng.run()


SCRIPTS = {
    "fcfs": (_script_fcfs, {}),
    "priority+chunked": (_script_priority_chunked,
                         dict(batch_slots=1, policy="priority",
                              prefill_chunk_tokens=8)),
}


def _counters(eng):
    m, pm = eng.metrics, eng.pool.metrics
    return {"distance": eng.pool.distance, "ticks": m.ticks,
            "prefills": m.prefills, "prefill_skips": m.prefill_skips,
            "chunk_passes": m.chunk_passes, "decode_steps": m.decode_steps,
            "preemptions": m.preemptions, "readmissions": m.readmissions,
            "tokens_emitted": m.tokens_emitted,
            "pages_allocated": pm.pages_allocated,
            "shared_hits": pm.shared_hits, "page_faults": pm.page_faults,
            "evictions": pm.evictions,
            "bytes_hot_written": pm.bytes_hot_written,
            "useful_preloads": pm.useful_preloads,
            "wasted_preloads": pm.wasted_preloads,
            "modeled_restore_time": pm.modeled_restore_time}


def _port_engine(cfg, params, sweep, **kw):
    return PagedServingEngine(cfg, params, PagedEngineConfig(
        **{**BASE, **kw}, sweep_decode=sweep, device="cpu", **TIERS))


def _engine_parity(models, script):
    """The script through the reference engine (fused sweep) and the port's
    sweep and per-layer engines: equal counters, equal tokens up to the
    reference's first near-tie, and the port's two paths bitwise equal."""
    ref_cfg, ref_params, cfg, params = models
    drive, kw = SCRIPTS[script]
    ref = _RefRecorder(ref_cfg, ref_params, RefEngineConfig(
        **{**BASE, **kw}, sweep_decode=True))
    ref.gaps = {}
    want = drive(ref, RefRequest)
    port = _port_engine(cfg, params, True, **kw)
    got = drive(port, Request)

    assert _counters(port) == _counters(ref)
    assert port.pool.metrics.page_faults >= 1
    port.pool.metrics.validate()
    compared = 0
    for rid, toks in want.items():
        ties = ref.gaps[rid]
        upto = ties.index(True) if True in ties else len(toks)
        assert got[rid][:upto] == toks[:upto], f"request {rid}"
        compared += upto
    assert compared >= sum(len(t) for t in want.values()) // 2

    # in-port contract: the per-layer path gives the sweep's tokens bitwise
    layer = _port_engine(cfg, params, False, **kw)
    assert drive(layer, Request) == got
    assert _counters(layer) == _counters(port)


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_engine_matches_reference_engine(models, script):
    _engine_parity(models, script)


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_deepseek_engine_matches_reference_engine(ds_models, script):
    """MLA + MoE through K3 (sweep) and K4 (per layer). MoE dispatch mixes
    the batch, so both engines run the same script at the same slots."""
    _engine_parity(ds_models, script)


def test_fcfs_script_exercises_sharing_replay_and_cold_tier(models):
    _, _, cfg, params = models
    eng = _port_engine(cfg, params, True)
    _script_fcfs(eng, Request)
    c = _counters(eng)
    assert c["shared_hits"] >= 1 and c["prefill_skips"] == 1
    assert c["evictions"] >= 1 and c["page_faults"] >= 1
    econ = eng.economics()
    assert econ["tiers"]["cold"]["bytes_moved"] > 0
    snap = eng.snapshot()
    assert snap["page_faults"] == c["page_faults"]
    assert eng.metrics_registry().get("pul_engine_page_faults",
                                      policy="fcfs") == c["page_faults"]


# ---------------------------------------------------------------- layout
@pytest.fixture(scope="module")
def layouts():
    ref_cfg = dataclasses.replace(ref_get_config(ARCH).reduced(), paged_kv=True)
    cfg = dataclasses.replace(get_config(ARCH).reduced(), paged_kv=True)
    return RefLayout(ref_cfg, 2, 16), PackedKVLayout(cfg, 2, 16)


def test_layout_geometry_matches_reference(layouts):
    ref, port = layouts
    assert port.features == ref.features
    assert [(e.plane_key, e.nfeat, e.offset) for e in port.entries] == \
        [(e.plane_key, e.nfeat, e.offset) for e in ref.entries]


def test_layout_plane_methods_match_reference(layouts):
    ref, port = layouts
    rng = np.random.default_rng(0)
    NF, P = 6, 8
    planes = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in
              port.init_planes(NF, P, torch.float32, "cpu").items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in planes.items()}
    jp = {k: jnp.asarray(v) for k, v in planes.items()}
    # frame read (cold-tier spill format)
    np.testing.assert_array_equal(port.read_frame_packed(tp, 3).numpy(),
                                  ref.read_frame_packed(jp, 3))
    # frame write (restore / prefill fill)
    rows = rng.standard_normal((P, port.features)).astype(np.float32)
    port.write_frame_packed(tp, 4, torch.from_numpy(rows))
    jp = ref.write_frame_packed(jp, 4, jnp.asarray(rows), jnp.float32)
    # eager token commit
    tok = rng.standard_normal((2, port.features)).astype(np.float32)
    frames, offs = np.asarray([2, 5]), np.asarray([7, 0])
    port.commit_token(tp, torch.from_numpy(tok), torch.as_tensor(frames),
                      torch.as_tensor(offs))
    jp = ref.commit_token(jp, jnp.asarray(tok), frames, offs, jnp.float32)
    for k in tp:
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))
    # a layer's frames are a view of the plane (no copy), as in the reference
    for k, view in port.layer_view(tp, 1).items():
        assert view.untyped_storage().data_ptr() == \
            tp[k].untyped_storage().data_ptr()
        np.testing.assert_array_equal(view.numpy(), np.asarray(
            ref.layer_view(jp, 1)[k]))


@pytest.fixture(scope="module")
def ds_layouts():
    ref_cfg = dataclasses.replace(ref_get_config(DEEPSEEK).reduced(),
                                  paged_kv=True)
    cfg = dataclasses.replace(get_config(DEEPSEEK).reduced(), paged_kv=True)
    return RefLayout(ref_cfg, 2, 16), PackedKVLayout(cfg, 2, 16)


def test_deepseek_layout_geometry_matches_reference(ds_layouts):
    """The dense layer's ungrouped (L = 1) MLA planes and the MoE groups'
    (L, NF, P, f) planes, in the reference's column order."""
    ref, port = ds_layouts
    test_layout_geometry_matches_reference(ds_layouts)
    assert [(e.grouped, e.layers, port.plane_shape(e, 6, 8))
            for e in port.entries] == \
        [(e.grouped, e.layers, ref.plane_shape(e, 6, 8)) for e in ref.entries]
    assert [e.plane_key for e in port.entries] == [
        "dense/0/c_kv", "dense/0/k_rope", "groups/0:moe/c_kv",
        "groups/0:moe/k_rope"]


def test_deepseek_layout_plane_methods_match_reference(ds_layouts):
    test_layout_plane_methods_match_reference(ds_layouts)
    ref, port = ds_layouts
    planes = port.init_planes(4, 8, torch.float32, "cpu")
    views = port.page_view_tree(planes)
    assert views["dense"]["0"]["c_kv"].shape == (4, 8, 32)        # layer dropped
    assert views["groups"]["0:moe"]["c_kv"].shape == (2, 4, 8, 32)


def test_deepseek_layout_pack_and_token_rows_match_reference(ds_layouts):
    ref, port = ds_layouts
    rng = np.random.default_rng(2)
    tree, rows_tree = {}, {}
    for e in port.entries:
        full = rng.standard_normal(e.shape).astype(np.float32)
        tok = full[:, :, 0] if e.grouped else full[:, 0]
        for t, leaf in ((tree, full), (rows_tree, tok)):
            t.setdefault(e.keys[0], {}).setdefault(e.keys[1], {})[e.keys[2]] = leaf
    as_t = lambda t: {a: {b: {c: torch.from_numpy(v) for c, v in d.items()}
                          for b, d in m.items()} for a, m in t.items()}
    packed = port.pack(as_t(tree))
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(ref.pack(jax.tree.map(jnp.asarray, tree))))
    np.testing.assert_array_equal(
        port.token_rows(as_t(rows_tree)).numpy(),
        np.asarray(ref._pack_new_rows_impl(jax.tree.map(jnp.asarray, rows_tree))))
    back = port.unpack_into({}, packed)
    for e in port.entries:
        np.testing.assert_array_equal(
            PackedKVLayout._get(back, e.keys).float().numpy(),
            torch.from_numpy(PackedKVLayout._get(tree, e.keys)).to(
                torch.bfloat16).float().numpy())


@pytest.mark.parametrize("which", ["qwen3", "deepseek"])
def test_layout_pack_planes_and_rows_match_reference(layouts, ds_layouts,
                                                     which):
    """The assembly path's layout pieces: the packed (NF, P, F) store from
    the planes, and one packed row per slot at per-slot positions."""
    ref, port = layouts if which == "qwen3" else ds_layouts
    rng = np.random.default_rng(3)
    planes = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in
              port.init_planes(5, 8, torch.float32, "cpu").items()}
    np.testing.assert_array_equal(
        port.pack_planes({k: torch.from_numpy(v) for k, v in planes.items()})
        .numpy(),
        np.asarray(ref.pack_planes({k: jnp.asarray(v)
                                    for k, v in planes.items()})))
    tree = {}
    for e in port.entries:
        node = tree
        for k in e.keys[:-1]:
            node = node.setdefault(k, {})
        node[e.keys[-1]] = rng.standard_normal(e.shape).astype(np.float32)
    idx = np.asarray([3, 15], np.int32)
    got = port.pack_rows(jax.tree.map(torch.from_numpy, tree),
                         torch.from_numpy(idx))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(ref.pack_rows(jax.tree.map(jnp.asarray, tree),
                                              jnp.asarray(idx))))


def test_layout_pack_unpack_roundtrip_matches_reference(layouts):
    ref, port = layouts
    rng = np.random.default_rng(1)
    e = port.entries[0]
    tree = {"groups": {"0:global": {
        k: rng.standard_normal(e.shape).astype(np.float32) for k in "kv"}}}
    ttree = {"groups": {"0:global": {k: torch.from_numpy(v) for k, v in
                                     tree["groups"]["0:global"].items()}}}
    packed = port.pack(ttree)
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(ref.pack(jax.tree.map(jnp.asarray, tree))))
    back = port.unpack_into({}, packed)
    for k in "kv":
        np.testing.assert_array_equal(
            back["groups"]["0:global"][k].float().numpy(),
            torch.from_numpy(tree["groups"]["0:global"][k]).to(
                torch.bfloat16).float().numpy())


# ---------------------------------------------------------------- pool
def test_planner_and_dma_twin_match_reference_on_reference_tiers():
    for P, feats, gqa in ((8, 128, 2), (16, 2 * 28 * 8 * 128, 2)):
        want = ref_plan(page_tokens=P, kv_features=feats, tier=REMOTE_HBM,
                        pe=TPU_V5E_VPU, gqa_group=gqa)
        got = plan_kv_page_stream(page_tokens=P, kv_features=feats,
                                  tier=TIERS["slow_tier"], pe=TIERS["pe"],
                                  gqa_group=gqa)
        assert got.cfg.distance == want.cfg.distance
        assert (got.bound, got.predicted_time_per_block) == \
            (want.bound, want.predicted_time_per_block)
    wl = dict(page_bytes=4096, flops_per_page=1e5, pages_per_step=5, steps=3)
    a = ref_run_workload(RefDMAEngine(REMOTE_HBM, TPU_V5E_VPU),
                         RefWorkload(**wl), distance=3)
    b = run_kv_page_workload(DMAEngine(TIERS["slow_tier"], TIERS["pe"]),
                             KVPageWorkload(**wl), distance=3)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


def test_full_width_distance_on_h100_tiers():
    """The engine's in-kernel distance at full qwen3 width (page geometry
    of the serving smoke): the planner's d* on the port's H100 tiers."""
    plan = plan_kv_page_stream(page_tokens=16, kv_features=2 * 28 * 8 * 128,
                               tier=PageConfig().slow_tier, pe=PageConfig().pe,
                               gqa_group=2)
    assert plan.cfg.distance == 4 and plan.bound == "bandwidth"


@pytest.mark.parametrize("layers,want", [(6, 28), (60, 8)])
def test_full_width_mla_distance_on_h100_tiers(layers, want):
    """deepseek-v2's packed page (layers x (512 + 64) features) is small, so
    the restore planner asks for a deep ring: d* = 28 at the smoke's six
    layers, 8 at sixty. The engine passes it to K3/K4, whose ring plan
    clamps it to the 10 slots a block holds at that width."""
    plan = plan_kv_page_stream(page_tokens=16, kv_features=layers * 576,
                               tier=PageConfig().slow_tier, pe=PageConfig().pe,
                               gqa_group=1)
    assert plan.cfg.distance == want


def test_pool_rejects_slabs_off_the_cp_async_granule():
    cfg = dataclasses.replace(get_config(ARCH).reduced(), head_dim=12,
                              paged_kv=True)
    layout = PackedKVLayout(cfg, 1, 8)
    with pytest.raises(ValueError, match="cp.async"):
        KVPagePool(PageConfig(page_tokens=1, hot_frames=4), layout=layout,
                   device="cpu")


def test_pool_metrics_validate_catches_drift():
    pm = PoolMetrics(page_faults=1)
    with pytest.raises(ValueError, match="PRELOAD descriptors"):
        pm.validate()
    PoolMetrics().validate()


def test_pool_packed_store_is_a_copy_of_the_planes():
    cfg = dataclasses.replace(get_config(DEEPSEEK).reduced(), paged_kv=True)
    layout = PackedKVLayout(cfg, 1, 16)
    pool = KVPagePool(PageConfig(page_tokens=8, hot_frames=5), layout=layout,
                      device="cpu")
    pid = pool.alloc()
    rows = torch.randn((8, layout.features)).to(torch.bfloat16)
    pool.write_page(pid, rows, 8)
    store = pool.packed_store()
    assert store.shape == (5, 8, layout.features)
    assert torch.equal(store[pool.pages[pid].frame], rows)
    store.zero_()
    assert torch.equal(layout.read_frame_packed(pool.planes,
                                                pool.pages[pid].frame), rows)


def test_pool_evict_restore_roundtrip_is_exact():
    cfg = dataclasses.replace(get_config(ARCH).reduced(), paged_kv=True)
    layout = PackedKVLayout(cfg, 1, 16)
    pool = KVPagePool(PageConfig(page_tokens=8, hot_frames=5), layout=layout,
                      device="cpu", **{})
    pid = pool.alloc()
    rows = torch.randn((8, layout.features)).to(torch.bfloat16)
    pool.write_page(pid, rows, 8)
    frame = pool.pages[pid].frame
    before = layout.read_frame_packed(pool.planes, frame).clone()
    pool.evict(pid)
    assert pool.pages[pid].frame is None and pid in pool.cold
    assert pool.ensure_hot([pid]) == 1
    after = layout.read_frame_packed(pool.planes, pool.pages[pid].frame)
    assert torch.equal(before, after)
    pool.metrics.validate()


# ---------------------------------------------------------------- surface
def test_unported_paths_raise(models):
    """shadow_check is ported (held against the reference in
    test_torch_sanitizer.py): the engine traces its pool and builds its
    checker. A pattern kind the reference lacks still raises at
    construction; the recurrent archs build (held against the reference in
    test_torch_recurrent_serving.py), rwkv6-7b with no pageable KV and its
    state in ``resident``."""
    _, _, cfg, params = models
    eng = PagedServingEngine(cfg, params, PagedEngineConfig(
        **{**BASE, "shadow_check": True}, device="cpu"))
    assert eng.pool.trace is not None and eng._shadow_checker is not None
    with pytest.raises(NotImplementedError, match="pattern kinds"):
        PagedServingEngine(dataclasses.replace(cfg, pattern=("conv",)),
                           params, PagedEngineConfig(**BASE, device="cpu"))
    for arch in ("rwkv6-7b", "zamba2-7b"):
        rcfg = get_config(arch).reduced()
        eng = PagedServingEngine(rcfg, init_params(rcfg, seed=0,
                                                   device="cpu"),
                                 PagedEngineConfig(**BASE, device="cpu"))
        assert eng._has_recurrent
        assert (eng.layout.features == 0) == (arch == "rwkv6-7b")


def test_serving_config_projects_device_and_kernel_default():
    sc = ServingConfig(device="cpu")
    assert sc.paged().device == "cpu" and sc.paged().use_paged_kernel
    assert ServingConfig().paged().device == "cuda"


def test_serve_cli_runs_on_cpu():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve.main(["--arch", ARCH, "--reduced", "--requests", "3",
                    "--max-new", "4", "--slots", "2", "--max-seq", "32",
                    "--page-tokens", "8", "--device", "cpu", "--no-sweep"])
    out = buf.getvalue()
    assert "per-layer decode" in out and "12 tokens" in out


@pytest.mark.parametrize("sweep", [True, False], ids=["sweep", "per-layer"])
def test_serve_cli_runs_deepseek_on_cpu(sweep):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve.main(["--arch", DEEPSEEK, "--reduced", "--requests", "3",
                    "--max-new", "4", "--slots", "2", "--max-seq", "32",
                    "--page-tokens", "8", "--device", "cpu",
                    *([] if sweep else ["--no-sweep"])])
    out = buf.getvalue()
    # 3 layers x (32 c_kv + 8 k_rope) packed features per token
    assert "120 packed features" in out and "12 tokens" in out
