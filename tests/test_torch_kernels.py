"""Port kernels K1-K4 (repro_torch.kernels.pul_attention) vs the reference.

On the CPU each wrapper takes its plain PyTorch version; the same numpy
inputs go through the reference's Pallas kernels in interpret mode. fp32
throughout, so the tolerance is the reference kernel tests' rtol = atol =
3e-4 (tests/test_kernels.py); committed plane rows are compared bitwise.
The CUDA kernels themselves run only on the card (tests/test_torch_cuda.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import PULConfig as RefPULConfig
from repro.core import IssueStrategy as RefIssueStrategy
from repro.kernels.pul_attention import (
    pul_paged_decode_attention as ref_k2,
    pul_paged_mla_decode_attention as ref_k4,
    pul_paged_sweep_decode_attention as ref_k1,
    pul_paged_sweep_mla_decode_attention as ref_k3,
)
from repro_torch.core import IssueStrategy, PULConfig
from repro_torch.kernels import pul_attention as PA

TOL = 3e-4

# (B, H, K, hd, P, n_pages, L, lengths, window, softcap, distance)
CASES = {
    "reduced": (3, 4, 2, 16, 8, 4, 2, [5, 32, 17], None, None, 3),
    "qwen3-width": (2, 16, 8, 128, 16, 3, 2, [33, 48], None, None, 2),
    "window+softcap": (3, 4, 2, 16, 8, 4, 2, [30, 9, 25], 11, 8.0, 2),
    "empty-cache": (2, 4, 2, 16, 8, 2, 2, [0, 0], None, None, 3),
    "d=1": (3, 4, 2, 16, 8, 4, 2, [1, 8, 31], None, None, 1),
}


def _inputs(B, H, K, hd, P, n_pages, L, lengths, seed=0):
    rng = np.random.default_rng(seed)
    NF = B * n_pages + 3
    f = lambda *s, a=1.0: (rng.standard_normal(s) * a).astype(np.float32)
    pt = (rng.permutation(NF - 2)[:B * n_pages] + 2).reshape(B, n_pages)
    lens = np.asarray(lengths, np.int32)
    frames = pt[np.arange(B), np.minimum(lens // P, n_pages - 1)]
    frames = np.where(lens == 0, 1, frames).astype(np.int32)   # TRASH frame
    return dict(q=f(B, H, hd, a=0.4), kp=f(L, NF, K, P, hd, a=0.4),
                vp=f(L, NF, K, P, hd), kn=f(B, K, hd, a=0.4), vn=f(B, K, hd),
                pt=pt.astype(np.int32), lens=lens, frames=frames,
                offs=(lens % P).astype(np.int32))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("case", sorted(CASES))
def test_sweep_plain_matches_reference_kernel(case):
    B, H, K, hd, P, n_pages, L, lengths, window, softcap, d = CASES[case]
    x = _inputs(B, H, K, hd, P, n_pages, L, lengths)
    layer = L - 1
    want, kp_ref, vp_ref = ref_k1(
        jnp.asarray(x["q"]), jnp.asarray(x["kp"]), jnp.asarray(x["vp"]), layer,
        jnp.asarray(x["pt"]), jnp.asarray(x["lens"]), jnp.asarray(x["kn"]),
        jnp.asarray(x["vn"]), jnp.asarray(x["frames"]), jnp.asarray(x["offs"]),
        cfg=RefPULConfig(distance=d), softcap=softcap, window=window)
    kp, vp = _t(x["kp"]), _t(x["vp"])
    got = PA.pul_paged_sweep_decode_attention(
        _t(x["q"]), kp, vp, layer, _t(x["pt"]), _t(x["lens"]), _t(x["kn"]),
        _t(x["vn"]), _t(x["frames"]), _t(x["offs"]),
        cfg=PULConfig(distance=d), softcap=softcap, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    # the fused commit: every plane row bitwise equal to the reference's
    np.testing.assert_array_equal(kp.numpy(), np.asarray(kp_ref))
    np.testing.assert_array_equal(vp.numpy(), np.asarray(vp_ref))
    if case == "empty-cache":
        np.testing.assert_allclose(got.numpy(), np.repeat(x["vn"], H // K, 1),
                                   rtol=1e-5, atol=1e-5)


# without a current token an empty cache has no visible position (the
# reference then averages masked rows, the port returns 0): not compared
@pytest.mark.parametrize("case,with_new", [
    (c, w) for c in sorted(CASES) for w in (True, False)
    if w or c != "empty-cache"])
def test_per_layer_plain_matches_reference_kernel(case, with_new):
    B, H, K, hd, P, n_pages, L, lengths, window, softcap, d = CASES[case]
    x = _inputs(B, H, K, hd, P, n_pages, L, lengths, seed=1)
    new = dict(k_new=x["kn"], v_new=x["vn"]) if with_new else {}
    want = ref_k2(jnp.asarray(x["q"]), jnp.asarray(x["kp"][0]),
                  jnp.asarray(x["vp"][0]), jnp.asarray(x["pt"]),
                  jnp.asarray(x["lens"]), cfg=RefPULConfig(distance=d),
                  softcap=softcap, window=window,
                  **{k: jnp.asarray(v) for k, v in new.items()})
    got = PA.pul_paged_decode_attention(
        _t(x["q"]), _t(x["kp"][0]), _t(x["vp"][0]), _t(x["pt"]),
        _t(x["lens"]), cfg=PULConfig(distance=d), softcap=softcap,
        window=window, **{k: _t(v) for k, v in new.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_sweep_and_per_layer_plain_versions_agree_bitwise():
    """The in-port contract behind sweep vs per-layer token equality: K1
    and K2 give the same `out` on the same inputs (the CUDA pair shares one
    templated body; their plain versions share one function)."""
    x = _inputs(*CASES["reduced"][:8], seed=2)
    layer = 1
    out2 = PA.pul_paged_decode_attention(
        _t(x["q"]), _t(x["kp"][layer]), _t(x["vp"][layer]), _t(x["pt"]),
        _t(x["lens"]), k_new=_t(x["kn"]), v_new=_t(x["vn"]))
    out1 = PA.pul_paged_sweep_decode_attention(
        _t(x["q"]), _t(x["kp"]), _t(x["vp"]), layer, _t(x["pt"]),
        _t(x["lens"]), _t(x["kn"]), _t(x["vn"]), _t(x["frames"]),
        _t(x["offs"]))
    assert torch.equal(out1, out2)


def test_bf16_plain_version_matches_fp32_reference():
    """The plain version in the model's working dtype (bf16 in, fp32 math,
    bf16 out) stays within two bf16 ulps of the fp32 reference kernel."""
    B, H, K, hd, P, n_pages, L, lengths, *_ = CASES["qwen3-width"]
    x = _inputs(B, H, K, hd, P, n_pages, L, lengths, seed=3)
    bf = lambda a: _t(a).to(torch.bfloat16)
    got = PA.pul_paged_decode_attention(
        bf(x["q"]), bf(x["kp"][0]), bf(x["vp"][0]), _t(x["pt"]), _t(x["lens"]),
        k_new=bf(x["kn"]), v_new=bf(x["vn"]))
    rt = lambda a: np.asarray(bf(a).float())        # the bf16-rounded inputs
    want = ref_k2(jnp.asarray(rt(x["q"])), jnp.asarray(rt(x["kp"][0])),
                  jnp.asarray(rt(x["vp"][0])), jnp.asarray(x["pt"]),
                  jnp.asarray(x["lens"]), k_new=jnp.asarray(rt(x["kn"])),
                  v_new=jnp.asarray(rt(x["vn"])))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               rtol=1.6e-2, atol=1.6e-2)


# ---------------------------------------------------------------- ring plan
@pytest.mark.parametrize("distance,strategy,want", [
    # full qwen3 width: the TPU tiers' d = 21 asks for 42 slots (336 KB);
    # 28 slots of 8 KB fit the 227 KB a block may use
    (21, IssueStrategy.BATCH, (21, 28)),
    (1, IssueStrategy.BATCH, (1, 2)),
    (4, IssueStrategy.SEQUENTIAL, (4, 5)),
    (64, IssueStrategy.BATCH, (28, 28)),
])
def test_ring_plan_clamps_to_shared_memory(distance, strategy, want):
    plan = PA.ring_plan(PULConfig(distance=distance, strategy=strategy),
                        G=2, P=16, hd=128)
    assert (plan.distance, plan.slots) == want
    assert plan.smem_bytes <= PA.SMEM_LIMIT_BYTES


def test_ring_plan_small_pages_clamp_to_wait_table():
    plan = PA.ring_plan(PULConfig(distance=64), G=2, P=8, hd=16)
    assert plan.distance == PA.MAX_RING_DISTANCE
    assert plan.slots == 2 * PA.MAX_RING_DISTANCE


def test_ring_plan_rejects_a_slab_beyond_shared_memory():
    with pytest.raises(ValueError, match="does not fit"):
        PA.ring_plan(PULConfig(distance=1), G=2, P=512, hd=256)


def test_wrapper_never_falls_back_off_cpu():
    """A tensor that is neither on the CPU nor on CUDA is refused: only CPU
    tensors take the plain version."""
    q = torch.empty((1, 4, 16), device="meta")
    pages = torch.empty((3, 2, 8, 16), device="meta")
    pt = torch.zeros((1, 2), dtype=torch.int32, device="meta")
    lens = torch.zeros((1,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        PA.pul_paged_decode_attention(q, pages, pages, pt, lens)


# ---------------------------------------------------------------- MLA: K3/K4
# (B, H, kvr, dr, P, n_pages, L, lengths): mixed fill levels, one slot empty
MLA_CASES = {
    "reduced": (3, 4, 32, 8, 8, 4, 2, [0, 17, 32]),
    "deepseek-heads": (2, 16, 64, 16, 16, 3, 2, [48, 5]),
}
MLA_RINGS = [(1, "batch"), (3, "batch"), (1, "seq"), (3, "seq")]


def _mla_inputs(B, H, kvr, dr, P, n_pages, L, lengths, seed=0):
    rng = np.random.default_rng(seed)
    NF = B * n_pages + 3
    f = lambda *s: (rng.standard_normal(s) * 0.4).astype(np.float32)
    pt = (rng.permutation(NF - 2)[:B * n_pages] + 2).reshape(B, n_pages)
    lens = np.asarray(lengths, np.int32)
    frames = pt[np.arange(B), np.minimum(lens // P, n_pages - 1)]
    frames = np.where(lens == 0, 1, frames).astype(np.int32)   # TRASH frame
    return dict(qa=f(B, H, kvr), qr=f(B, H, dr), cp=f(L, NF, P, kvr),
                rp=f(L, NF, P, dr), cn=f(B, kvr), rn=f(B, dr),
                pt=pt.astype(np.int32), lens=lens, frames=frames,
                offs=(lens % P).astype(np.int32),
                scale=1.0 / np.sqrt(kvr // 2 + dr))


def _ring(d, strategy):
    seq = strategy == "seq"
    return (RefPULConfig(distance=d, strategy=(RefIssueStrategy.SEQUENTIAL if seq
                                               else RefIssueStrategy.BATCH)),
            PULConfig(distance=d, strategy=(IssueStrategy.SEQUENTIAL if seq
                                            else IssueStrategy.BATCH)))


@pytest.mark.parametrize("case", sorted(MLA_CASES))
@pytest.mark.parametrize("d,strategy", MLA_RINGS)
def test_mla_sweep_plain_matches_reference_kernel(case, d, strategy):
    """K3's plain version against the reference's Pallas kernel in
    interpret mode: `out` within 3e-4, both planes bitwise after the
    commit."""
    B, H, kvr, dr, P, n_pages, L, lengths = MLA_CASES[case]
    x = _mla_inputs(*MLA_CASES[case])
    ref_cfg, cfg = _ring(d, strategy)
    layer = L - 1
    j = {k: jnp.asarray(v) for k, v in x.items() if k != "scale"}
    want, cp_ref, rp_ref = ref_k3(
        j["qa"], j["qr"], j["cp"], j["rp"], layer, j["pt"], j["lens"],
        j["cn"], j["rn"], j["frames"], j["offs"], scale=x["scale"],
        cfg=ref_cfg)
    cp, rp = _t(x["cp"]), _t(x["rp"])
    got = PA.pul_paged_sweep_mla_decode_attention(
        _t(x["qa"]), _t(x["qr"]), cp, rp, layer, _t(x["pt"]), _t(x["lens"]),
        _t(x["cn"]), _t(x["rn"]), _t(x["frames"]), _t(x["offs"]),
        scale=x["scale"], cfg=cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(cp.numpy(), np.asarray(cp_ref))
    np.testing.assert_array_equal(rp.numpy(), np.asarray(rp_ref))
    # an empty slot sees only its current token: out == c_new
    for b in np.flatnonzero(x["lens"] == 0):
        np.testing.assert_allclose(got[b].numpy(), np.repeat(
            x["cn"][b][None], H, 0), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", sorted(MLA_CASES))
@pytest.mark.parametrize("d,strategy", MLA_RINGS)
def test_mla_per_layer_plain_matches_reference_kernel(case, d, strategy):
    x = _mla_inputs(*MLA_CASES[case], seed=1)
    ref_cfg, cfg = _ring(d, strategy)
    j = {k: jnp.asarray(v) for k, v in x.items() if k != "scale"}
    want = ref_k4(j["qa"], j["qr"], j["cp"][0], j["rp"][0], j["pt"],
                  j["lens"], j["cn"], j["rn"], scale=x["scale"], cfg=ref_cfg)
    got = PA.pul_paged_mla_decode_attention(
        _t(x["qa"]), _t(x["qr"]), _t(x["cp"][0]), _t(x["rp"][0]), _t(x["pt"]),
        _t(x["lens"]), _t(x["cn"]), _t(x["rn"]), scale=x["scale"], cfg=cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_mla_sweep_and_per_layer_plain_versions_agree_bitwise():
    x = _mla_inputs(*MLA_CASES["reduced"], seed=2)
    layer = 1
    args = [_t(x[k]) for k in ("pt", "lens", "cn", "rn")]
    out4 = PA.pul_paged_mla_decode_attention(
        _t(x["qa"]), _t(x["qr"]), _t(x["cp"][layer]), _t(x["rp"][layer]),
        *args, scale=x["scale"])
    out3 = PA.pul_paged_sweep_mla_decode_attention(
        _t(x["qa"]), _t(x["qr"]), _t(x["cp"]), _t(x["rp"]), layer, *args,
        _t(x["frames"]), _t(x["offs"]), scale=x["scale"])
    assert torch.equal(out3, out4)


@pytest.mark.parametrize("H,distance,strategy,want", [
    # deepseek-v2 width: 8-head blocks, 10 slots of 18,432 B fit beside
    # 35,424 B of q, accumulator and softmax state; the planner's d* at six
    # layers (28) is clamped to them
    (128, 28, IssueStrategy.BATCH, (10, 10, 219744)),
    (128, 28, IssueStrategy.SEQUENTIAL, (9, 10, 219744)),
    (128, 4, IssueStrategy.BATCH, (4, 8, 182880)),
    (128, 1, IssueStrategy.BATCH, (1, 2, 72288)),
])
def test_mla_ring_plan_clamps_to_shared_memory(H, distance, strategy, want):
    plan = PA.mla_ring_plan(PULConfig(distance=distance, strategy=strategy),
                            H=H, P=16, kvr=512, dr=64)
    assert (plan.distance, plan.slots, plan.smem_bytes) == want
    assert plan.smem_bytes <= PA.SMEM_LIMIT_BYTES


@pytest.mark.parametrize("H,want", [(128, 8), (4, 4), (6, 2), (16, 8)])
def test_mla_head_block_divides_the_heads(H, want):
    assert PA.head_block(H) == want and H % want == 0


def test_mla_ring_plan_rejects_a_slab_beyond_shared_memory():
    with pytest.raises(ValueError, match="does not fit"):
        PA.mla_ring_plan(PULConfig(distance=1), H=128, P=256, kvr=512, dr=64)


def test_mla_wrappers_never_fall_back_off_cpu():
    q = torch.empty((1, 4, 32), device="meta")
    qr = torch.empty((1, 4, 8), device="meta")
    cp = torch.empty((3, 8, 32), device="meta")
    rp = torch.empty((3, 8, 8), device="meta")
    i32 = lambda *s: torch.zeros(s, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        PA.pul_paged_mla_decode_attention(q, qr, cp, rp, i32(1, 2), i32(1),
                                          q[:, 0], qr[:, 0], scale=0.1)
    with pytest.raises(ValueError, match="CUDA tensors"):
        PA.pul_paged_sweep_mla_decode_attention(
            q, qr, cp[None], rp[None], 0, i32(1, 2), i32(1), q[:, 0],
            qr[:, 0], i32(1), i32(1), scale=0.1)
