"""The port's CUDA kernels on the card (marker `cuda`; skipped without one).

No JAX here: the machine with the card has none. Run there with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The gather K5 is held against its plain version bitwise (it moves bytes),
in f32, bf16 and int32 and at the two serving page geometries, and so is
the filter K9 on f32, bf16 and f16 tables (ties at the threshold rounded to
the table's type) in both modes, at unload distances 0, 1 and 3 and at row
widths that take either copy of its bit-vector ring. The SUM K8 is
held exactly to the fp64 sum on values that make every order exact, and to
the reference's tolerance on normal values; the matmul K10 to the
reference's tolerances. K1/K2 and
the MLA pair K3/K4 are held against their plain PyTorch versions
in bf16 (two bf16 ulps of each (b, h) row's largest value: the card sums in
another order), K1 == K2 and K3 == K4 bitwise, and the sweep kernels'
commits bitwise equal to the plain commits. Planted faults (the last visible
page of the longest row skipped, the current token not folded, and one
split left out of the merge) must fall outside that limit; that check
also runs on the CPU. K1-K4 are also held at forced split counts, from one
split to one page a split, K3/K4 with NaN and Inf in the masked rows of the
pages they read, and K5's bulk copies at ragged and 16-byte rows. The dense attention
pair, K7 (flash attention) and K6 (decode over a dense cache), is held the
same way in bf16 and to rtol = atol = 3e-4 in f32, at d = 1 and 4 in both
issue orders, with its own planted faults (the last KV chunk lost, the
softcap dropped); K6 also at every head dim and G of 1, 2, 5 and 16 with
rows of length 0, 1 and S, and at forced segment sizes, where one
segment's piece left out of the merge must be rejected, and a plan whose
chunk is not the kernel's is refused. The paged engine's decode step
captured as one CUDA graph (reduced qwen3 and deepseek-v2, sweep and per
layer) gives the eager step's logits, tokens, planes, PoolMetrics and launch
counts bitwise, and refuses planes reallocated behind its back and a step
that reads the device back.
"""
import dataclasses
import importlib

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import IssueStrategy, PULConfig
from repro_torch.kernels import ops
from repro_torch.kernels.pul_decode import (
    decode_attention_kernel_ref,
    decode_attention_split_ref,
    pul_decode_attention,
)
from repro_torch.kernels.pul_filter import (
    filter_materialize_ref,
    filter_ref,
    pul_filter,
)
from repro_torch.kernels.pul_gather import (
    gather_ref,
    page_gather_ref,
    pul_gather,
    pul_page_gather,
)
from repro_torch.kernels.pul_matmul import (
    matmul_body,
    matmul_ref,
    pul_matmul,
)
from repro_torch.kernels.pul_sum import pul_sum, sum_ref
from repro_torch.models import init_params
from repro_torch.serving import (
    PackedKVLayout, PagedEngineConfig, PagedServingEngine, Request)
from repro_torch.serving.capture import StepNotCapturable

# the module (the package exports the function pul_attention under its name)
PA = importlib.import_module("repro_torch.kernels.pul_attention")



def _limit(want):
    """Two bf16 ulps of each (b, h) row's largest |value|."""
    top = want.float().abs().amax(dim=-1, keepdim=True)
    return 2.0 * torch.exp2(torch.floor(torch.log2(top.clamp_min(2.0 ** -126))) - 7)


def _close(got, want):
    return bool(((got.float() - want.float()).abs() <= _limit(want)).all())


def _assert_close(got, want):
    err = ((got.float() - want.float()).abs() / _limit(want)).max().item()
    assert _close(got, want), f"error up to {err:.1f} x two bf16 ulps of the row max"


def _assert_faults_rejected(c, kp, vp, want, kw):
    """The limit rejects the plain version with the last visible page of the
    longest row skipped, and with the current token not folded in."""
    P = kp.shape[-2]
    cut = c["lens"].clone()
    row = int(cut.argmax())
    cut[row] = (int(cut[row]) - 1) // P * P
    skipped = PA.paged_decode_attention_ref(c["q"], kp, vp, c["pt"], cut,
                                            k_new=c["kn"], v_new=c["vn"], **kw)
    unfolded = PA.paged_decode_attention_ref(c["q"], kp, vp, c["pt"], c["lens"],
                                             **kw)
    assert not _close(skipped, want)
    assert not _close(unfolded, want)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


def _case(dev, B, H, K, hd, P, n_pages, L, lengths, seed=0):
    rng = np.random.default_rng(seed)
    NF = B * n_pages + 3
    bf = lambda *s: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)).to(dev, torch.bfloat16)
    pt = (rng.permutation(NF - 2)[:B * n_pages] + 2).reshape(B, n_pages)
    lens = np.asarray(lengths, np.int32)
    frames = pt[np.arange(B), np.minimum(lens // P, n_pages - 1)]
    frames = np.where(lens == 0, 1, frames)
    i32 = lambda a: torch.from_numpy(np.asarray(a, np.int32)).to(dev)
    return dict(q=bf(B, H, hd), kp=bf(L, NF, K, P, hd), vp=bf(L, NF, K, P, hd),
                kn=bf(B, K, hd), vn=bf(B, K, hd), pt=i32(pt), lens=i32(lens),
                frames=i32(frames), offs=i32(lens % P))


CASES = {
    "qwen3-width": ((3, 16, 8, 128, 16, 5, 2, [0, 33, 79]), {}),
    "reduced+window+softcap": ((3, 4, 2, 16, 8, 6, 2, [47, 9, 16]),
                               dict(window=11, softcap=8.0)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("cfg", [
    PULConfig(distance=1), PULConfig(distance=3),
    PULConfig(distance=3, strategy=IssueStrategy.SEQUENTIAL)],
    ids=["d1", "d3", "d3-seq"])
def test_kernels_match_plain_versions(dev, case, cfg):
    shape, kw = CASES[case]
    c = _case(dev, *shape)
    kp0, vp0 = c["kp"].clone(), c["vp"].clone()
    want_no_new = PA.paged_decode_attention_ref(
        c["q"], kp0[1], vp0[1], c["pt"], c["lens"], **kw)
    out2 = PA.pul_paged_decode_attention(
        c["q"], c["kp"][1], c["vp"][1], c["pt"], c["lens"], k_new=c["kn"],
        v_new=c["vn"], cfg=cfg, **kw)
    no_new = PA.pul_paged_decode_attention(
        c["q"], c["kp"][1], c["vp"][1], c["pt"], c["lens"], cfg=cfg, **kw)
    out1 = PA.pul_paged_sweep_decode_attention(
        c["q"], c["kp"], c["vp"], 1, c["pt"], c["lens"], c["kn"], c["vn"],
        c["frames"], c["offs"], cfg=cfg, **kw)
    torch.cuda.synchronize()
    want = PA.paged_sweep_decode_attention_ref(
        c["q"], kp0, vp0, 1, c["pt"], c["lens"], c["kn"], c["vn"],
        c["frames"], c["offs"], **kw)
    _assert_close(out1, want)
    _assert_close(no_new, want_no_new)
    assert torch.equal(out1, out2)
    assert torch.equal(c["kp"], kp0) and torch.equal(c["vp"], vp0)
    _assert_faults_rejected(c, kp0[1], vp0[1], want, kw)


@pytest.mark.parametrize("case", sorted(CASES))
def test_limit_rejects_planted_faults_on_cpu(case):
    shape, kw = CASES[case]
    c = _case(torch.device("cpu"), *shape)
    want = PA.paged_sweep_decode_attention_ref(
        c["q"], c["kp"], c["vp"], 1, c["pt"], c["lens"], c["kn"], c["vn"],
        c["frames"], c["offs"], **kw)
    _assert_close(PA.paged_decode_attention_ref(
        c["q"], c["kp"][1], c["vp"][1], c["pt"], c["lens"], k_new=c["kn"],
        v_new=c["vn"], **kw), want)
    _assert_faults_rejected(c, c["kp"][1], c["vp"][1], want, kw)


@pytest.mark.cuda
def test_launches_are_counted_and_checks_raise(dev):
    c = _case(dev, 2, 4, 2, 16, 8, 2, 1, [3, 9])
    before = dict(PA.LAUNCHES)
    PA.pul_paged_sweep_decode_attention(
        c["q"], c["kp"], c["vp"], 0, c["pt"], c["lens"], c["kn"], c["vn"],
        c["frames"], c["offs"])
    PA.pul_paged_decode_attention(c["q"], c["kp"][0], c["vp"][0], c["pt"],
                                  c["lens"])
    assert PA.LAUNCHES["k1"] == before["k1"] + 1
    assert PA.LAUNCHES["k2"] == before["k2"] + 1
    with pytest.raises(TypeError, match="dtype"):
        PA.pul_paged_decode_attention(c["q"].float(), c["kp"][0], c["vp"][0],
                                      c["pt"], c["lens"])
    with pytest.raises(ValueError, match="outside"):
        PA.pul_paged_sweep_decode_attention(
            c["q"], c["kp"], c["vp"], 1, c["pt"], c["lens"], c["kn"],
            c["vn"], c["frames"], c["offs"])


@pytest.mark.cuda
@pytest.mark.parametrize("n_split", [1, 2, 8, 64])
@pytest.mark.parametrize("cfg", [
    PULConfig(distance=1), PULConfig(distance=3),
    PULConfig(distance=3, strategy=IssueStrategy.SEQUENTIAL)],
    ids=["d1", "d3", "d3-seq"])
def test_kernels_hold_at_every_split_count(dev, cfg, n_split):
    """qwen3 width over 64 pages, rows of 0, 1, 999 and 1000 tokens, at
    forced split counts: K1 and K2 within the limit of the plain version,
    K1 == K2 bitwise, the commit bitwise, one launch a call, and a merge
    that drops one split outside the limit."""
    c = _case(dev, 4, 16, 8, 128, 16, 64, 2, [0, 1, 999, 1000])
    kp0, vp0 = c["kp"].clone(), c["vp"].clone()
    before = dict(PA.LAUNCHES)
    out2 = PA.pul_paged_decode_attention(
        c["q"], c["kp"][1], c["vp"][1], c["pt"], c["lens"], k_new=c["kn"],
        v_new=c["vn"], cfg=cfg, n_split=n_split)
    out1 = PA.pul_paged_sweep_decode_attention(
        c["q"], c["kp"], c["vp"], 1, c["pt"], c["lens"], c["kn"], c["vn"],
        c["frames"], c["offs"], cfg=cfg, n_split=n_split)
    no_new = PA.pul_paged_decode_attention(
        c["q"], kp0[1], vp0[1], c["pt"], c["lens"], cfg=cfg, n_split=n_split)
    torch.cuda.synchronize()
    assert PA.LAUNCHES["k1"] == before["k1"] + 1
    assert PA.LAUNCHES["k2"] == before["k2"] + 2
    want = PA.paged_sweep_decode_attention_ref(
        c["q"], kp0, vp0, 1, c["pt"], c["lens"], c["kn"], c["vn"],
        c["frames"], c["offs"])
    _assert_close(out1, want)
    _assert_close(no_new, PA.paged_decode_attention_ref(
        c["q"], kp0[1], vp0[1], c["pt"], c["lens"]))
    assert torch.equal(out1, out2)
    assert torch.equal(c["kp"], kp0) and torch.equal(c["vp"], vp0)
    dropped = PA.paged_decode_split_ref(
        c["q"], kp0[1], vp0[1], c["pt"], c["lens"], n_split=n_split,
        k_new=c["kn"], v_new=c["vn"], drop_split=n_split // 2)
    assert not _close(dropped, want)


@pytest.mark.cuda
@pytest.mark.parametrize("G", [1, 5, 8, 16])
@pytest.mark.parametrize("hd", [32, 64, 112, 256])
def test_kernels_take_other_head_dims_and_groups(dev, hd, G):
    """Every lane-group width (hd / 8 lanes a key) and head bound of the
    split kernel: K1 within the limit of the plain version, K1 == K2."""
    c = _case(dev, 3, 2 * G, 2, hd, 16, 6, 2, [0, 17, 90], seed=hd + G)
    kp0, vp0 = c["kp"].clone(), c["vp"].clone()
    out2 = PA.pul_paged_decode_attention(
        c["q"], c["kp"][1], c["vp"][1], c["pt"], c["lens"], k_new=c["kn"],
        v_new=c["vn"], softcap=8.0)
    out1 = PA.pul_paged_sweep_decode_attention(
        c["q"], c["kp"], c["vp"], 1, c["pt"], c["lens"], c["kn"], c["vn"],
        c["frames"], c["offs"], softcap=8.0)
    torch.cuda.synchronize()
    want = PA.paged_sweep_decode_attention_ref(
        c["q"], kp0, vp0, 1, c["pt"], c["lens"], c["kn"], c["vn"],
        c["frames"], c["offs"], softcap=8.0)
    _assert_close(out1, want)
    assert torch.equal(out1, out2)
    assert torch.equal(c["kp"], kp0) and torch.equal(c["vp"], vp0)


def _served(arch, B, n_pages, lengths):
    """K1/K2's geometry at `arch`'s full width on 16-token pages of
    two-layer planes: (B, H, K, hd, P, n_pages, L, lengths), and its
    options (softcap and window, where the model has them)."""
    cfg = get_config(arch)
    opts = {k: v for k, v in (("softcap", cfg.attn_softcap),
                              ("window", cfg.sliding_window)) if v}
    return (B, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, 16, n_pages, 2,
            lengths), opts


#: the served models' K1/K2 geometries. The lengths fall before, at and
#: past the window, and where the window's first position is a page's
#: first (length - window + 1 a multiple of P)
SERVED = {
    "qwen2.5-32b": _served("qwen2.5-32b", 4, 64, [0, 1, 700, 1023]),
    "gemma2-27b": _served("gemma2-27b", 6, 384,
                          [4000, 4095, 4096, 4111, 5015, 6143]),
    "gemma3-12b": _served("gemma3-12b", 6, 256,
                          [1000, 1023, 1024, 1039, 2100, 4095]),
    # grok-1's group of 6 with softcap 30, musicgen's MHA (group 1) at hd 64
    "grok-1-314b": _served("grok-1-314b", 5, 64, [0, 17, 512, 1000, 1023]),
    "musicgen-large": _served("musicgen-large", 5, 64,
                              [1, 16, 300, 999, 1023]),
}


@pytest.mark.cuda
@pytest.mark.parametrize("n_split", [None, 1, 7, 128])
@pytest.mark.parametrize("model", sorted(SERVED))
def test_kernels_hold_at_the_served_geometries(dev, model, n_split):
    """K1 and K2 at qwen2.5-32b's group of 5, gemma2-27b's softcap and
    window of 4096, gemma3-12b's hd 256 and window of 1024, grok-1's group
    of 6 with softcap 30 and musicgen's group of 1 at hd 64, at the
    plan's split count and at forced ones; at 128 splits gemma3's rows (at
    most 65 visible pages) and qwen2.5's short rows leave splits that see
    no page, which must weigh 0 in the merge. Within the limit of the plain version, K1 == K2 bitwise,
    the commit bitwise, and a merge that drops one split outside it."""
    shape, kw = SERVED[model]
    c = _case(dev, *shape, seed=len(model))
    kp0, vp0 = c["kp"].clone(), c["vp"].clone()
    out2 = PA.pul_paged_decode_attention(
        c["q"], c["kp"][1], c["vp"][1], c["pt"], c["lens"], k_new=c["kn"],
        v_new=c["vn"], n_split=n_split, **kw)
    out1 = PA.pul_paged_sweep_decode_attention(
        c["q"], c["kp"], c["vp"], 1, c["pt"], c["lens"], c["kn"], c["vn"],
        c["frames"], c["offs"], n_split=n_split, **kw)
    torch.cuda.synchronize()
    want = PA.paged_sweep_decode_attention_ref(
        c["q"], kp0, vp0, 1, c["pt"], c["lens"], c["kn"], c["vn"],
        c["frames"], c["offs"], **kw)
    _assert_close(out1, want)
    assert torch.equal(out1, out2)
    assert torch.equal(c["kp"], kp0) and torch.equal(c["vp"], vp0)
    n = n_split or PA.split_plan_for(
        PULConfig(), tuple(c["q"].shape), tuple(c["kp"].shape),
        c["pt"].shape[1],
        torch.cuda.get_device_properties(dev).multi_processor_count).n_split
    if n > 1:
        dropped = PA.paged_decode_split_ref(
            c["q"], kp0[1], vp0[1], c["pt"], c["lens"], n_split=n,
            k_new=c["kn"], v_new=c["vn"], drop_split=0, **kw)
        assert not _close(dropped, want)
    _assert_faults_rejected(c, kp0[1], vp0[1], want, kw)


# ---------------------------------------------------------------- MLA: K3/K4
def _mla_case(dev, B, H, kvr, dr, P, n_pages, L, lengths, seed=0):
    rng = np.random.default_rng(seed)
    NF = B * n_pages + 3
    bf = lambda *s: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)).to(dev, torch.bfloat16)
    pt = (rng.permutation(NF - 2)[:B * n_pages] + 2).reshape(B, n_pages)
    lens = np.asarray(lengths, np.int32)
    frames = pt[np.arange(B), np.minimum(lens // P, n_pages - 1)]
    frames = np.where(lens == 0, 1, frames)
    i32 = lambda a: torch.from_numpy(np.asarray(a, np.int32)).to(dev)
    return dict(qa=bf(B, H, kvr), qr=bf(B, H, dr), cp=bf(L, NF, P, kvr),
                rp=bf(L, NF, P, dr), cn=bf(B, kvr), rn=bf(B, dr), pt=i32(pt),
                lens=i32(lens), frames=i32(frames), offs=i32(lens % P),
                scale=1.0 / float(np.sqrt(kvr // 4 + dr)))


MLA_CASES = {
    "reduced": (3, 4, 32, 8, 8, 6, 2, [0, 17, 40]),
    # one split block of 64 head rows: 48 of them padding, then none
    "h16": (3, 16, 64, 16, 16, 6, 2, [0, 17, 90]),
    "h64": (4, 64, 512, 64, 16, 8, 2, [0, 1, 16, 120]),
    # pages of two 16-key chunks, and of 24 rows (8 of the slot's padding);
    # no row is full (the engine never decodes one: its commit row would
    # lie past the last page)
    "p32": (3, 16, 64, 16, 32, 4, 2, [0, 40, 127]),
    "p24": (3, 16, 64, 8, 24, 4, 2, [5, 30, 95]),
    # deepseek-v2 width: 128 heads in two split blocks of 64, kv_lora 512,
    # rope 64
    "deepseek-width": (8, 128, 512, 64, 16, 64, 2,
                       [0, 7, 16, 1000, 513, 250, 64, 999]),
}


def _assert_mla_faults_rejected(c, cp, rp, want):
    P = cp.shape[-2]
    cut = c["lens"].clone()
    row = int(cut.argmax())
    cut[row] = (int(cut[row]) - 1) // P * P
    args = (c["qa"], c["qr"], cp, rp, c["pt"])
    skipped = PA.paged_mla_decode_attention_ref(*args, cut, c["cn"], c["rn"],
                                                scale=c["scale"])
    unfolded = PA.paged_mla_decode_attention_ref(*args, c["lens"], None, None,
                                                 scale=c["scale"])
    assert not _close(skipped, want)
    assert not _close(unfolded, want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(MLA_CASES))
@pytest.mark.parametrize("cfg", [
    PULConfig(distance=1), PULConfig(distance=3),
    PULConfig(distance=3, strategy=IssueStrategy.SEQUENTIAL)],
    ids=["d1", "d3", "d3-seq"])
def test_mla_kernels_match_plain_versions(dev, case, cfg):
    """K3/K4 at H 4, 16, 64 and 128 (one or two split blocks of 64 head
    rows) against the plain version; K3 == K4 and the commit bitwise."""
    c = _mla_case(dev, *MLA_CASES[case])
    cp0, rp0 = c["cp"].clone(), c["rp"].clone()
    rest = (c["pt"], c["lens"], c["cn"], c["rn"])
    out4 = PA.pul_paged_mla_decode_attention(
        c["qa"], c["qr"], c["cp"][1], c["rp"][1], *rest, scale=c["scale"],
        cfg=cfg)
    out3 = PA.pul_paged_sweep_mla_decode_attention(
        c["qa"], c["qr"], c["cp"], c["rp"], 1, *rest, c["frames"], c["offs"],
        scale=c["scale"], cfg=cfg)
    torch.cuda.synchronize()
    want = PA.paged_sweep_mla_decode_attention_ref(
        c["qa"], c["qr"], cp0, rp0, 1, *rest, c["frames"], c["offs"],
        scale=c["scale"])
    _assert_close(out3, want)
    assert torch.equal(out3, out4)
    assert torch.equal(c["cp"], cp0) and torch.equal(c["rp"], rp0)
    _assert_mla_faults_rejected(c, cp0[1], rp0[1], want)


@pytest.mark.parametrize("case", sorted(MLA_CASES))
def test_mla_limit_rejects_planted_faults_on_cpu(case):
    c = _mla_case(torch.device("cpu"), *MLA_CASES[case])
    want = PA.paged_sweep_mla_decode_attention_ref(
        c["qa"], c["qr"], c["cp"], c["rp"], 1, c["pt"], c["lens"], c["cn"],
        c["rn"], c["frames"], c["offs"], scale=c["scale"])
    _assert_close(PA.paged_mla_decode_attention_ref(
        c["qa"], c["qr"], c["cp"][1], c["rp"][1], c["pt"], c["lens"], c["cn"],
        c["rn"], scale=c["scale"]), want)
    _assert_mla_faults_rejected(c, c["cp"][1], c["rp"][1], want)


MLA_RINGS = [PULConfig(distance=1), PULConfig(distance=3),
             PULConfig(distance=3, strategy=IssueStrategy.SEQUENTIAL)]


@pytest.mark.cuda
@pytest.mark.parametrize("n_split", [1, 2, 8, 64])
@pytest.mark.parametrize("cfg", MLA_RINGS, ids=["d1", "d3", "d3-seq"])
def test_mla_kernels_hold_at_every_split_count(dev, cfg, n_split):
    """deepseek-v2 width over 64 pages, rows of 0, 1, 999 and 1000 tokens,
    at forced split counts: K3 and K4 within the limit of the plain version,
    K3 == K4 bitwise, the commit bitwise, one launch a call, and a merge
    that drops one split outside the limit."""
    c = _mla_case(dev, 4, 128, 512, 64, 16, 64, 2, [0, 1, 999, 1000])
    cp0, rp0 = c["cp"].clone(), c["rp"].clone()
    rest = (c["pt"], c["lens"], c["cn"], c["rn"])
    before = dict(PA.LAUNCHES)
    out4 = PA.pul_paged_mla_decode_attention(
        c["qa"], c["qr"], c["cp"][1], c["rp"][1], *rest, scale=c["scale"],
        cfg=cfg, n_split=n_split)
    out3 = PA.pul_paged_sweep_mla_decode_attention(
        c["qa"], c["qr"], c["cp"], c["rp"], 1, *rest, c["frames"], c["offs"],
        scale=c["scale"], cfg=cfg, n_split=n_split)
    torch.cuda.synchronize()
    assert PA.LAUNCHES["k3"] == before["k3"] + 1
    assert PA.LAUNCHES["k4"] == before["k4"] + 1
    want = PA.paged_sweep_mla_decode_attention_ref(
        c["qa"], c["qr"], cp0, rp0, 1, *rest, c["frames"], c["offs"],
        scale=c["scale"])
    _assert_close(out3, want)
    assert torch.equal(out3, out4)
    assert torch.equal(c["cp"], cp0) and torch.equal(c["rp"], rp0)
    dropped = PA.paged_mla_decode_split_ref(
        c["qa"], c["qr"], cp0[1], rp0[1], *rest, scale=c["scale"],
        n_split=n_split, drop_split=n_split // 2)
    assert not _close(dropped, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n_split", [1, 8])
@pytest.mark.parametrize("cfg", [MLA_RINGS[0], MLA_RINGS[2]],
                         ids=["d1", "d3-seq"])
def test_mla_kernels_ignore_nan_in_masked_rows(dev, cfg, n_split):
    """NaN (c_kv) and Inf (k_rope) in every row at or past `length` of each
    row's tail page, the commit row among them: K4 and K3 give a finite
    `out`, bitwise the one they give on clean pages (a masked row never
    enters the value product, where 0 x Inf would be NaN)."""
    c = _mla_case(dev, 4, 128, 512, 64, 16, 64, 2, [5, 17, 999, 40])
    rest = (c["pt"], c["lens"], c["cn"], c["rn"])
    kw = dict(scale=c["scale"], cfg=cfg, n_split=n_split)
    clean = PA.pul_paged_mla_decode_attention(
        c["qa"], c["qr"], c["cp"][1], c["rp"][1], *rest, **kw)
    P = c["cp"].shape[2]
    for b, n in enumerate(c["lens"].tolist()):
        frame = int(c["pt"][b, n // P])
        c["cp"][1, frame, n % P:] = float("nan")
        c["rp"][1, frame, n % P:] = float("inf")
    out4 = PA.pul_paged_mla_decode_attention(
        c["qa"], c["qr"], c["cp"][1], c["rp"][1], *rest, **kw)
    out3 = PA.pul_paged_sweep_mla_decode_attention(
        c["qa"], c["qr"], c["cp"], c["rp"], 1, *rest, c["frames"], c["offs"],
        **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(out3).all()
    assert torch.equal(out3, clean) and torch.equal(out4, clean)


@pytest.mark.cuda
def test_mla_launches_are_counted_and_checks_raise(dev):
    c = _mla_case(dev, 2, 4, 32, 8, 8, 2, 1, [3, 9])
    rest = (c["pt"], c["lens"], c["cn"], c["rn"])
    before = dict(PA.LAUNCHES)
    PA.pul_paged_sweep_mla_decode_attention(
        c["qa"], c["qr"], c["cp"], c["rp"], 0, *rest, c["frames"], c["offs"],
        scale=c["scale"])
    PA.pul_paged_mla_decode_attention(c["qa"], c["qr"], c["cp"][0],
                                      c["rp"][0], *rest, scale=c["scale"])
    assert PA.LAUNCHES["k3"] == before["k3"] + 1
    assert PA.LAUNCHES["k4"] == before["k4"] + 1
    k4 = lambda qa, cp, **kw: PA.pul_paged_mla_decode_attention(
        qa, c["qr"], cp, c["rp"][0], *rest, scale=c["scale"], **kw)
    with pytest.raises(TypeError, match="dtype"):
        k4(c["qa"].float(), c["cp"][0])
    with pytest.raises(ValueError, match="contiguous"):
        k4(c["qa"].transpose(0, 1).contiguous().transpose(0, 1), c["cp"][0])
    with pytest.raises(ValueError, match="on cpu"):
        k4(c["qa"], c["cp"][0].cpu())
    with pytest.raises(ValueError, match="outside"):
        PA.pul_paged_sweep_mla_decode_attention(
            c["qa"], c["qr"], c["cp"], c["rp"], 1, *rest, c["frames"],
            c["offs"], scale=c["scale"])
    big = _mla_case(dev, 1, 4, 512, 64, 256, 1, 1, [3])
    with pytest.raises(ValueError, match="does not fit"):
        PA.pul_paged_mla_decode_attention(
            big["qa"], big["qr"], big["cp"][0], big["rp"][0], big["pt"],
            big["lens"], big["cn"], big["rn"], scale=big["scale"])
    odd = _mla_case(dev, 1, 4, 48, 8, 8, 1, 1, [3])
    with pytest.raises(ValueError, match="multiples of 32"):
        PA.pul_paged_mla_decode_attention(
            odd["qa"], odd["qr"], odd["cp"][0], odd["rp"][0], odd["pt"],
            odd["lens"], odd["cn"], odd["rn"], scale=odd["scale"])


# ---------------------------------------------------------------- gather: K5
@pytest.mark.cuda
@pytest.mark.parametrize("strategy", [IssueStrategy.BATCH,
                                      IssueStrategy.SEQUENTIAL])
@pytest.mark.parametrize("distance", [1, 2, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32])
def test_gather_kernel_matches_plain_version(dev, dtype, distance, strategy):
    rng = np.random.default_rng(0)
    table = torch.from_numpy(rng.standard_normal((64, 256)).astype(
        np.float32) * 100).to(dev, dtype)
    trace = torch.from_numpy(rng.integers(0, 64, size=40).astype(
        np.int32)).to(dev)
    got = pul_gather(table, trace,
                     cfg=PULConfig(distance=distance, strategy=strategy))
    torch.cuda.synchronize()
    assert torch.equal(got, gather_ref(table, trace))


def _packed_width(arch):
    """The packed KV row's width of `arch` at full depth (PackedKVLayout)."""
    cfg = dataclasses.replace(get_config(arch), paged_kv=True)
    return PackedKVLayout(cfg, 1, 16).features


# (n_pages, P, F) at the serving geometries, cut to a few frames: full-width
# qwen3-1.7b (28 layers x 2 x 8 x 128), deepseek-v2 at six layers (6 x 576,
# the ragged last tile) and the local/global models at full depth (rows of
# 262,144, 376,832 and 393,216 B: 8-12 chunks of 32 KB a row)
GATHER_CASES = {"qwen3": (6, 16, 57344), "deepseek": (9, 16, 3456),
                **{arch: (6, 16, _packed_width(arch))
                   for arch in ("qwen2.5-32b", "gemma2-27b", "gemma3-12b")}}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(GATHER_CASES))
@pytest.mark.parametrize("distance", [1, 4, 14])
def test_page_gather_kernel_matches_plain_version(dev, case, distance):
    NP, P, F = GATHER_CASES[case]
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    store = torch.randn((NP, P, F), generator=gen, device=dev,
                        dtype=torch.bfloat16)
    # repeated frames and the zero frame past a slot's end, as the engine
    pt = torch.tensor([[2, 5, 3, 0], [4, 4, 0, 0], [1, 3, 5, 2]],
                      dtype=torch.int32, device=dev)
    got = pul_page_gather(store, pt, cfg=PULConfig(distance=distance))
    torch.cuda.synchronize()
    assert torch.equal(got, page_gather_ref(store, pt))


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", [
    PULConfig(distance=1), PULConfig(distance=4),
    PULConfig(distance=4, strategy=IssueStrategy.SEQUENTIAL),
    PULConfig(distance=14)], ids=["d1", "d4", "d4-seq", "d14"])
@pytest.mark.parametrize("rows_per_req", [1, 16])
@pytest.mark.parametrize("row_bytes", [16, 6912])
def test_gather_kernel_takes_ragged_and_tiny_rows(dev, row_bytes,
                                                  rows_per_req, cfg):
    """Bitwise at deepseek-v2's 6,912 B rows (a 110,592 B page: three 32 KB
    chunks and a ragged 12,288 B one) and at 16-byte rows (a chunk of one
    granule), with repeated trace entries."""
    rng = np.random.default_rng(5)
    W = row_bytes // 2
    table = torch.from_numpy(rng.standard_normal(
        (12 * rows_per_req, W)).astype(np.float32)).to(dev, torch.bfloat16)
    trace = torch.from_numpy(np.array([3, 0, 11, 3, 3, 7, 0, 5, 9, 1, 2,
                                       11, 4], np.int32)).to(dev)
    before = PA.LAUNCHES["k5"]
    got = pul_gather(table, trace, cfg=cfg, rows_per_req=rows_per_req)
    torch.cuda.synchronize()
    assert PA.LAUNCHES["k5"] == before + 1
    want = gather_ref(table.reshape(12, rows_per_req * W), trace)
    assert torch.equal(got, want.reshape(-1, W))


@pytest.mark.cuda
def test_gather_launches_are_counted_and_checks_raise(dev):
    table = torch.randn((16, 64), device=dev)
    trace = torch.tensor([3, 0, 3], dtype=torch.int32, device=dev)
    before = PA.LAUNCHES["k5"]
    pul_gather(table, trace)
    pul_page_gather(table.reshape(2, 8, 64), trace[:2].reshape(1, 2))
    assert PA.LAUNCHES["k5"] == before + 2
    with pytest.raises(TypeError, match="dtype"):
        pul_gather(table.double(), trace)
    with pytest.raises(TypeError, match="dtype"):
        pul_gather(table, trace.long())
    with pytest.raises(ValueError, match="contiguous"):
        pul_gather(table.t().contiguous().t(), trace)
    with pytest.raises(ValueError, match="on cpu"):
        pul_gather(table, trace.cpu())
    with pytest.raises(ValueError, match="granules"):
        pul_gather(table[:, :6].contiguous().bfloat16(), trace)
    assert PA.LAUNCHES["k5"] == before + 2


# ------------------------------------------- the microbenchmarks: K8-K10
def _eighths(rng, shape, dev, dtype=torch.float32):
    """Normal values rounded to multiples of 1/8 (|x| < 8): exact in bf16,
    and every partial sum of a few million of them is exact in fp32, so a
    sum in any order equals the fp64 sum."""
    x = np.clip(np.round(rng.standard_normal(shape) * 8) / 8, -7.875, 7.875)
    return torch.from_numpy(x.astype(np.float32)).to(dev, dtype)


MICRO_CFGS = [PULConfig(distance=1), PULConfig(distance=4),
              PULConfig(distance=3, strategy=IssueStrategy.SEQUENTIAL),
              PULConfig(distance=16)]
MICRO_IDS = ["d1", "d4", "d3-seq", "d16"]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(32, 128, 18), (4096, 16, 5000)],
                         ids=["reference", "64B-rows"])
@pytest.mark.parametrize("rows_per_req", [1, 4, 16])
@pytest.mark.parametrize("cfg", MICRO_CFGS, ids=MICRO_IDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sum_kernel_matches_plain_version(dev, dtype, cfg, rows_per_req,
                                          shape):
    R, W, n = shape
    rng = np.random.default_rng(0)
    data = _eighths(rng, (R * rows_per_req, W), dev, dtype)
    trace = torch.from_numpy(rng.integers(0, R, size=n).astype(
        np.int32)).to(dev)
    got = pul_sum(data, trace, cfg=cfg, rows_per_req=rows_per_req)
    again = pul_sum(data, trace, cfg=cfg, rows_per_req=rows_per_req)
    torch.cuda.synchronize()
    rows = data.reshape(R, rows_per_req * W)[trace.long()]
    assert got.item() == rows.double().sum().item()     # exact on eighths
    assert torch.equal(got, again)                      # no atomics
    normal = torch.from_numpy(rng.standard_normal(
        (R * rows_per_req, W)).astype(np.float32)).to(dev, dtype)
    np.testing.assert_allclose(
        pul_sum(normal, trace, cfg=cfg, rows_per_req=rows_per_req).item(),
        sum_ref(normal.reshape(R, rows_per_req * W), trace).item(),
        rtol=3e-2 if dtype == torch.bfloat16 else 1e-5)


def _words(t):
    return t.view(torch.int32) if t.dtype == torch.uint32 else t


def _filter_table(rng, rows, row_bytes, dtype, dev):
    """Eighths in the table's type, with column 0 planted at the threshold
    0.3 rounded to that type and one ulp either side of it: the compare
    must be the one in the table's type."""
    width = row_bytes // torch.tensor([], dtype=dtype).element_size()
    data = _eighths(rng, (rows * 40, width), dev, dtype)
    thr = torch.tensor(0.3, dtype=dtype)
    up = torch.nextafter(thr, torch.tensor(1.0, dtype=dtype))
    down = torch.nextafter(thr, torch.tensor(0.0, dtype=dtype))
    data[::7, 0] = thr.item()
    data[3::11, 0] = up.item()
    data[5::13, 0] = down.item()
    return data


@pytest.mark.cuda
@pytest.mark.parametrize("rows,row_bytes", [(128, 256), (64, 128),
                                            (128, 64), (96, 16)])
@pytest.mark.parametrize("unload_distance", [0, 1, 3])
@pytest.mark.parametrize("cfg", MICRO_CFGS[1:3] + [PULConfig(distance=8)],
                         ids=["d4", "d3-seq", "d8"])
@pytest.mark.parametrize("materialize", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_filter_kernel_matches_plain_version(dev, dtype, materialize, cfg,
                                             unload_distance, rows,
                                             row_bytes):
    """K9 on f32, bf16 and f16 tables, in both modes, bitwise against the
    plain versions, with ties at the rounded threshold."""
    data = _filter_table(np.random.default_rng(1), rows, row_bytes, dtype,
                         dev)
    cfg = dataclasses.replace(cfg, unload_distance=unload_distance)
    before = PA.LAUNCHES["k9"]
    got = pul_filter(data, 0.3, cfg=cfg, rows_per_block=rows,
                     materialize=materialize)
    torch.cuda.synchronize()
    assert PA.LAUNCHES["k9"] == before + 1
    want = (filter_materialize_ref(data, 0.3) if materialize
            else filter_ref(data, 0.3))
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(_words(got), _words(want))


@pytest.mark.cuda
@pytest.mark.parametrize("row_bytes", [16, 32, 48, 64, 80, 128, 192, 256])
@pytest.mark.parametrize("rows", [64, 128, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_filter_bitvector_takes_every_row_width(dev, dtype, rows, row_bytes):
    """The bit-vector's tiles are the first 64 bytes of each row, or the row
    when shorter: one bulk copy of the block for rows up to 64 B, TMA 2D
    boxes (up to 256 rows) from a tensor map for wider ones. The same bits
    as the plain version every time."""
    data = _filter_table(np.random.default_rng(2), rows, row_bytes, dtype,
                         dev)
    got = pul_filter(data, 0.3, rows_per_block=rows)
    torch.cuda.synchronize()
    assert torch.equal(_words(got), _words(filter_ref(data, 0.3)))


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", [PULConfig(distance=1), PULConfig(distance=3),
                                 PULConfig(distance=3,
                                           strategy=IssueStrategy.SEQUENTIAL)],
                         ids=["d1", "d3", "d3-seq"])
@pytest.mark.parametrize("shape,blocks", [
    ((128, 128, 128), (64, 64, 64)),
    ((128, 256, 384), (64, 128, 128)),
    ((64, 512, 128), (64, 64, 128)),
    ((256, 256, 256), (128, 128, 128)),
    ((96, 64, 160), (32, 32, 32)),
])
@pytest.mark.parametrize("dtype,out_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.bfloat16)])
def test_matmul_kernel_matches_plain_version(dev, dtype, out_dtype, shape,
                                             blocks, cfg):
    M, K, N = shape
    bm, bk, bn = blocks
    rng = np.random.default_rng(2)
    a = torch.from_numpy(rng.standard_normal((M, K)).astype(
        np.float32)).to(dev, dtype)
    b = torch.from_numpy(rng.standard_normal((K, N)).astype(
        np.float32)).to(dev, dtype)
    got = pul_matmul(a, b, cfg=cfg, bm=bm, bk=bk, bn=bn, out_dtype=out_dtype)
    torch.cuda.synchronize()
    want = matmul_ref(a, b)
    assert got.dtype == out_dtype
    rtol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    if out_dtype == torch.bfloat16:
        rtol = 2 ** -7                 # one bf16 rounding of the result
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.cpu().numpy(), rtol=rtol, atol=rtol * 10)


def _matmul_limit(a, b):
    """2 sqrt(K) 2^-24 (|A| |B|): the random-walk size of fp32 rounding in a
    K-term sum with every partial sum at its largest."""
    K = a.shape[1]
    return 2.0 * K ** 0.5 * 2.0 ** -24 * (a.float().abs() @ b.float().abs())


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", [
    PULConfig(distance=d, strategy=s) for d in (1, 3) for s in IssueStrategy],
    ids=[f"d{d}-{s.name.lower()}" for d in (1, 3) for s in IssueStrategy])
@pytest.mark.parametrize("shape,blocks", [
    ((128, 128, 128), (64, 64, 64)),
    ((128, 256, 384), (64, 128, 128)),
    ((64, 512, 128), (64, 64, 128)),
    ((256, 256, 256), (128, 128, 128)),
    ((128, 96, 96), (128, 32, 32)),
])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_matmul_wgmma_body_matches_plain_version(dev, out_dtype, shape,
                                                 blocks, cfg):
    """bf16 with bm >= 64 runs the tensor-core body: within 2 sqrt(K)
    2^-24 (|A||B|) of the fp32 product (f32 out), or one bf16 rounding of
    it (bf16 out); a planted fault (one K chunk of 16 left out) is not."""
    M, K, N = shape
    bm, bk, bn = blocks
    assert matmul_body(torch.bfloat16, bm, bn) == "wgmma"
    rng = np.random.default_rng(5)
    a, b = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(
        dev, torch.bfloat16) for s in ((M, K), (K, N)))
    before = (PA.LAUNCHES["k10"], PA.LAUNCHES["k10_wgmma"])
    got = pul_matmul(a, b, cfg=cfg, bm=bm, bk=bk, bn=bn, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert (PA.LAUNCHES["k10"], PA.LAUNCHES["k10_wgmma"]) == (
        before[0] + 1, before[1] + 1)
    want = matmul_ref(a, b)
    limit = _matmul_limit(a, b)
    if out_dtype == torch.bfloat16:
        limit = limit + want.abs() * 2.0 ** -8      # the output's rounding
    assert got.dtype == out_dtype
    err = (got.float() - want).abs()
    assert bool((err <= limit).all()), f"{(err / limit).max().item():.2f} x"
    bad = want - a[:, :16].float() @ b[:16].float()
    assert not bool(((bad - want).abs() <= limit).all())


@pytest.mark.cuda
def test_micro_launches_are_counted_and_checks_raise(dev):
    data = torch.randn((64, 16), device=dev)
    trace = torch.tensor([3, 0, 3], dtype=torch.int32, device=dev)
    before = {k: PA.LAUNCHES[k] for k in ("k8", "k9", "k10")}
    pul_sum(data, trace)
    pul_filter(data, 0.0, rows_per_block=32)
    pul_matmul(data[:32], data[:32].T.contiguous(), bm=32, bk=16, bn=32)
    assert {k: PA.LAUNCHES[k] - before[k] for k in before} == {
        "k8": 1, "k9": 1, "k10": 1}
    with pytest.raises(TypeError, match="dtype"):
        pul_sum(data.double(), trace)
    with pytest.raises(TypeError, match="dtype"):
        pul_sum(data, trace.long())
    with pytest.raises(ValueError, match="contiguous"):
        pul_sum(data.t().contiguous().t(), trace)
    with pytest.raises(ValueError, match="granules"):
        pul_sum(data[:, :2].contiguous(), trace)
    with pytest.raises(TypeError, match="dtype"):
        pul_filter(data.double(), 0.0, rows_per_block=32)
    with pytest.raises(ValueError, match="granules"):
        pul_filter(data[:, :6].contiguous(), 0.0, rows_per_block=32)
    with pytest.raises(ValueError, match="built"):
        pul_matmul(data, data[:16], bm=16, bk=16, bn=16)
    with pytest.raises(TypeError, match="kernel takes"):
        pul_matmul(data[:32].double(), data[:32].T.contiguous().double(),
                   bm=32, bk=16, bn=32)
    assert {k: PA.LAUNCHES[k] - before[k] for k in before} == {
        "k8": 1, "k9": 1, "k10": 1}


# ------------------------------------------------- dense attention: K6/K7
def _dense_close(got, want):
    """bf16: two bf16 ulps of each row's largest |value|; f32: rtol = atol
    = 3e-4 (the reference's f32 kernel tolerance)."""
    if want.dtype == torch.bfloat16:
        return _close(got, want)
    return bool(((got.float() - want.float()).abs()
                 <= 3e-4 + 3e-4 * want.float().abs()).all())


def _dense(dev, dtype, *shapes, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return [(torch.randn(s, generator=gen) * a).to(dev, dtype)
            for s, a in shapes]


# (B, H, K, T, S, options): hd = 128
ATTN_CASES = {
    "causal-gqa2": (2, 4, 2, 80, 160, dict(bt=16)),
    "softcap+window+tail": (1, 8, 2, 64, 200,
                            dict(softcap=2.0, window=50, bt=64)),
    "rows-before-keys": (1, 2, 1, 96, 48, dict(bt=32, bs=40)),
    "window-no-causal": (1, 2, 2, 64, 130, dict(causal=False, window=30)),
}
DENSE_CFGS = [PULConfig(distance=d, strategy=s) for d in (1, 4)
              for s in IssueStrategy]
DENSE_IDS = [f"d{d}-{s.name.lower()}" for d in (1, 4) for s in IssueStrategy]


def _attn_case(dev, case, dtype):
    B, H, K, T, S, kw = ATTN_CASES[case]
    qs = 3.0 if "softcap" in kw else 0.3     # logits the softcap bends
    q, k, v = _dense(dev, dtype, ((B, H, T, 128), qs), ((B, K, S, 128), 0.3),
                     ((B, K, S, 128), 1.0))
    return q, k, v, kw


def _attn_faults(q, k, v, kw):
    """The plain version with the last KV chunk the kernel streams left
    out (its keys zeroed), and with the softcap dropped (or, without one,
    the scale doubled)."""
    S = k.shape[2]
    cut = max(0, S - 32)
    kz, vz = k.clone(), v.clone()
    kz[:, :, cut:] = 0
    vz[:, :, cut:] = 0
    ref_kw = {n: x for n, x in kw.items() if n != "bt"}
    wrong = (dict(ref_kw, softcap=None) if kw.get("softcap")
             else dict(ref_kw, scale=2.0 / q.shape[-1] ** 0.5))
    return {"last chunk left out": PA.attention_kernel_ref(q, kz, vz, **ref_kw),
            "softcap or scale wrong": PA.attention_kernel_ref(q, k, v, **wrong)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(ATTN_CASES))
@pytest.mark.parametrize("cfg", DENSE_CFGS, ids=DENSE_IDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernel_matches_plain_version(dev, dtype, cfg, case):
    q, k, v, kw = _attn_case(dev, case, dtype)
    got = PA.pul_attention(q, k, v, cfg=cfg, **kw)
    torch.cuda.synchronize()
    ref_kw = {n: x for n, x in kw.items() if n != "bt"}
    want = PA.attention_kernel_ref(q, k, v, **ref_kw)
    assert got.dtype == dtype
    err = (got.float() - want.float()).abs().max().item()
    assert _dense_close(got, want), f"max |K7 - plain| {err:.3e}"
    for what, bad in _attn_faults(q, k, v, kw).items():
        assert not _dense_close(bad, want), what


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_limit_rejects_planted_faults_on_cpu(dtype, case):
    q, k, v, kw = _attn_case(torch.device("cpu"), case, dtype)
    want = PA.attention_kernel_ref(
        q, k, v, **{n: x for n, x in kw.items() if n != "bt"})
    assert _dense_close(PA.pul_attention(q, k, v, **kw), want)
    for what, bad in _attn_faults(q, k, v, kw).items():
        assert not _dense_close(bad, want), what


# K7 at every head dim the kernels are built for and at group sizes that do
# and do not divide 64 (qwen2.5-32b's 5, grok's 6); each group size takes
# its own mask options: (T, S, options)
SHAPE_OPTS = {
    1: (40, 100, dict()),
    2: (40, 100, dict(softcap=2.0, window=30)),
    5: (40, 100, dict(causal=False, window=30)),
    6: (96, 48, dict(bt=32, bs=40)),
}


def _shape_case(dev, dtype, hd, G):
    T, S, kw = SHAPE_OPTS[G]
    qs = 3.0 if "softcap" in kw else 0.3     # logits the softcap bends
    q, k, v = _dense(dev, dtype, ((1, 2 * G, T, hd), qs), ((1, 2, S, hd), 0.3),
                     ((1, 2, S, hd), 1.0), seed=hd + G)
    return q, k, v, kw


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", DENSE_CFGS, ids=DENSE_IDS)
@pytest.mark.parametrize("G", sorted(SHAPE_OPTS))
@pytest.mark.parametrize("hd", PA.DENSE_HDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernel_takes_every_head_dim_and_group(dev, dtype, hd, G,
                                                         cfg):
    q, k, v, kw = _shape_case(dev, dtype, hd, G)
    before = (PA.LAUNCHES["k7"], PA.LAUNCHES["k7_tc"])
    got = PA.pul_attention(q, k, v, cfg=cfg, **kw)
    torch.cuda.synchronize()
    tc = int(dtype == torch.bfloat16)
    assert (PA.LAUNCHES["k7"], PA.LAUNCHES["k7_tc"]) == (before[0] + 1,
                                                         before[1] + tc)
    ref_kw = {n: x for n, x in kw.items() if n != "bt"}
    want = PA.attention_kernel_ref(q, k, v, **ref_kw)
    err = (got.float() - want.float()).abs().max().item()
    assert _dense_close(got, want), f"max |K7 - plain| {err:.3e}"
    for what, bad in _attn_faults(q, k, v, kw).items():
        assert not _dense_close(bad, want), what


# (B, H, K, S, lengths, options): hd = 128
DECODE_CASES = {
    "qwen3-heads": (4, 16, 8, 1000, [1000, 999, 1, 0], {}),
    "segments+softcap": (2, 4, 2, 5000, [5000, 2100], dict(softcap=2.0)),
    "group16": (2, 16, 1, 300, [300, 129], dict(bs=64)),
}


def _decode_case(dev, case, dtype):
    B, H, K, S, lengths, kw = DECODE_CASES[case]
    qs = 3.0 if "softcap" in kw else 0.3     # logits the softcap bends
    q, k, v = _dense(dev, dtype, ((B, H, 128), qs), ((B, K, S, 128), 0.3),
                     ((B, K, S, 128), 1.0), seed=1)
    return q, k, v, torch.tensor(lengths, dtype=torch.int32, device=dev), kw


def _decode_faults(q, k, v, length, kw):
    """The plain version with the longest row's last 64 keys left out, and
    with the softcap dropped (or, without one, the scale doubled)."""
    cut = length.clone()
    row = int(cut.argmax())
    cut[row] -= 64
    wrong = (dict(kw, softcap=None) if kw.get("softcap")
             else dict(kw, scale=2.0 / q.shape[-1] ** 0.5))
    return {"last chunk left out": decode_attention_kernel_ref(
                q, k, v, cut, **kw),
            "softcap or scale wrong": decode_attention_kernel_ref(
                q, k, v, length, **wrong)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(DECODE_CASES))
@pytest.mark.parametrize("cfg", DENSE_CFGS, ids=DENSE_IDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_matches_plain_version(dev, dtype, cfg, case):
    q, k, v, length, kw = _decode_case(dev, case, dtype)
    got = pul_decode_attention(q, k, v, length, cfg=cfg, **kw)
    torch.cuda.synchronize()
    want = decode_attention_kernel_ref(q, k, v, length, **kw)
    err = (got.float() - want.float()).abs().max().item()
    assert _dense_close(got, want), f"max |K6 - plain| {err:.3e}"
    for what, bad in _decode_faults(q, k, v, length, kw).items():
        assert not _dense_close(bad, want), what


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", DENSE_CFGS, ids=DENSE_IDS)
@pytest.mark.parametrize("G", [5, 6])
@pytest.mark.parametrize("hd", [64, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_takes_other_head_dims_and_groups(dev, dtype, hd, G,
                                                        cfg):
    """K6 at musicgen's hd 64 and gemma3's 256, G 5 and 6, over 3,000 keys
    (segments) with a length-0 row."""
    q, k, v = _dense(dev, dtype, ((3, 2 * G, hd), 0.3), ((3, 2, 3000, hd), 0.3),
                     ((3, 2, 3000, hd), 1.0), seed=hd + G)
    length = torch.tensor([3000, 1234, 0], dtype=torch.int32, device=dev)
    got = pul_decode_attention(q, k, v, length, cfg=cfg)
    torch.cuda.synchronize()
    want = decode_attention_kernel_ref(q, k, v, length)
    err = (got.float() - want.float()).abs().max().item()
    assert _dense_close(got, want), f"max |K6 - plain| {err:.3e}"
    for what, bad in _decode_faults(q, k, v, length, {}).items():
        assert not _dense_close(bad, want), what


@pytest.mark.cuda
@pytest.mark.parametrize("seg_chunks", [None, 1])
@pytest.mark.parametrize("G", [1, 2, 5, 16])
@pytest.mark.parametrize("hd", PA.DENSE_HDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_at_every_head_dim_and_group(dev, dtype, hd, G,
                                                   seg_chunks):
    """K6 at every hd it is built for and G 1/2/5/16, rows of length S, 1,
    0 and one inside a chunk, the softcap on, with the card's balanced
    segments and with one chunk a segment (a piece a chunk)."""
    S = 700
    q, k, v = _dense(dev, dtype, ((4, 2 * G, hd), 3.0), ((4, 2, S, hd), 0.3),
                     ((4, 2, S, hd), 1.0), seed=hd + 3 * G)
    length = torch.tensor([S, 1, 0, 333], dtype=torch.int32, device=dev)
    before = PA.LAUNCHES["k6"]
    got = pul_decode_attention(q, k, v, length, softcap=2.0,
                               seg_chunks=seg_chunks)
    torch.cuda.synchronize()
    assert PA.LAUNCHES["k6"] == before + 1
    want = decode_attention_kernel_ref(q, k, v, length, softcap=2.0)
    err = (got.float() - want.float()).abs().max().item()
    assert _dense_close(got, want), f"max |K6 - plain| {err:.3e}"


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", DENSE_CFGS, ids=DENSE_IDS)
@pytest.mark.parametrize("seg_chunks", [None, 1, 2, 7, 1000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_holds_at_every_segment_size(dev, dtype, seg_chunks,
                                                   cfg):
    """K6 with the segment size forced, from a chunk a segment to the whole
    stream in one, at d 1 and 4 in both orders; the split-and-merge model
    agrees, and leaving one segment's piece out of the merge is rejected."""
    q, k, v = _dense(dev, dtype, ((3, 8, 128), 0.3), ((3, 4, 2000, 128), 0.3),
                     ((3, 4, 2000, 128), 1.0), seed=11)
    length = torch.tensor([2000, 1500, 0], dtype=torch.int32, device=dev)
    got = pul_decode_attention(q, k, v, length, cfg=cfg,
                               seg_chunks=seg_chunks)
    torch.cuda.synchronize()
    want = decode_attention_kernel_ref(q, k, v, length)
    err = (got.float() - want.float()).abs().max().item()
    assert _dense_close(got, want), f"max |K6 - plain| {err:.3e}"
    split = decode_attention_split_ref(q, k, v, length, cfg=cfg,
                                       seg_chunks=seg_chunks)
    assert _dense_close(split, want)
    if seg_chunks is not None and seg_chunks < 100:
        dropped = decode_attention_split_ref(q, k, v, length, cfg=cfg,
                                             seg_chunks=seg_chunks,
                                             drop_piece=1)
        assert not _dense_close(dropped, want)


@pytest.mark.cuda
def test_decode_kernel_refuses_a_plan_not_its_own(dev, monkeypatch):
    """The host plans the rows' partial slots with its own chunk size
    (decode_chunk_keys): a plan whose chunk is not the kernel's is refused
    before launch, not run with slots the kernel would overrun."""
    q, k, v = _dense(dev, torch.bfloat16, ((2, 4, 128), 0.3),
                     ((2, 2, 1000, 128), 0.3), ((2, 2, 1000, 128), 1.0))
    length = torch.tensor([1000, 17], dtype=torch.int32, device=dev)
    PD = importlib.import_module("repro_torch.kernels.pul_decode")
    own = PD.decode_chunk_keys
    monkeypatch.setattr(PD, "decode_chunk_keys",
                        lambda hd, itemsize, G=2: 2 * own(hd, itemsize, G))
    before = PA.LAUNCHES["k6"]
    with pytest.raises(RuntimeError, match="pul_decode_attention"):
        pul_decode_attention(q, k, v, length)
    assert PA.LAUNCHES["k6"] == before


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_limit_rejects_planted_faults_on_cpu(dtype, case):
    q, k, v, length, kw = _decode_case(torch.device("cpu"), case, dtype)
    want = decode_attention_kernel_ref(q, k, v, length, **kw)
    assert _dense_close(pul_decode_attention(q, k, v, length, **kw), want)
    for what, bad in _decode_faults(q, k, v, length, kw).items():
        assert not _dense_close(bad, want), what


@pytest.mark.cuda
def test_dense_launches_are_counted_and_checks_raise(dev):
    q, k, v = _dense(dev, torch.bfloat16, ((1, 4, 64, 128), 1.0),
                     ((1, 2, 64, 128), 1.0), ((1, 2, 64, 128), 1.0))
    qd = q[:, :, 0].contiguous()
    length = torch.tensor([40], dtype=torch.int32, device=dev)
    before = {n: PA.LAUNCHES[n] for n in ("k6", "k7", "k7_tc")}
    ops.attention_op(q, k, v)
    pul_decode_attention(qd, k, v, length)
    # G = 3 does not divide 64 rows, hd 64: the kernel takes both
    PA.pul_attention(q[:, :3, :, :64].contiguous(), k[:, :1, :, :64].contiguous(),
                     v[:, :1, :, :64].contiguous())
    torch.cuda.synchronize()
    launched = {"k6": 1, "k7": 2, "k7_tc": 2}
    assert {n: PA.LAUNCHES[n] - before[n] for n in before} == launched
    with pytest.raises(ValueError, match="is on"):
        PA.pul_attention(q, k.cpu(), v)
    with pytest.raises(TypeError, match="dtype"):
        PA.pul_attention(q.double(), k.double(), v.double())
    with pytest.raises(TypeError, match="dtype"):
        PA.pul_attention(q, k.float(), v)
    with pytest.raises(ValueError, match="built for"):
        PA.pul_attention(q[..., :24].contiguous(), k[..., :24].contiguous(),
                         v[..., :24].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        PA.pul_attention(q, k.transpose(2, 3).contiguous().transpose(2, 3), v)
    with pytest.raises(TypeError, match="dtype"):
        pul_decode_attention(qd.float(), k, v, length)
    with pytest.raises(ValueError, match="shape"):
        pul_decode_attention(qd, k, v, torch.tensor([40, 3], device=dev))
    with pytest.raises(ValueError, match="at most"):
        pul_decode_attention(
            torch.zeros((1, 34, 128), dtype=torch.bfloat16, device=dev),
            k[:, :2], v[:, :2], length)
    assert {n: PA.LAUNCHES[n] - before[n] for n in before} == launched


# ------------------------------------------------- the captured decode step
#: the zoo models served through K1/K2 without windows: grok-1 (MoE,
#: einsum dispatch), internvl2 (a frontend in prefill only) and musicgen
#: (sinusoidal positions, MHA)
ZOO = ("grok-1-314b", "internvl2-2b", "musicgen-large")


@pytest.fixture(scope="module")
def reduced_models():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    out = {}
    for arch in ("qwen3-1.7b", "deepseek-v2-236b", "gemma2-27b",
                 "gemma3-12b", *ZOO):
        cfg = get_config(arch).reduced()
        out[arch] = (cfg, init_params(cfg, seed=0, device="cuda"))
    return out


def _capture_script(models, arch, sweep, capture):
    """Four requests over three slots with a preempt/resume through the
    cold tier. Returns (every emitted logit row by request, the engine, the
    launches of the run)."""
    cfg, params = models[arch]
    eng = PagedServingEngine(cfg, params, PagedEngineConfig(
        batch_slots=3, max_seq=64, page_tokens=8, prefill_buckets=(8, 16, 32),
        sweep_decode=sweep, capture_decode=capture, device="cuda"))
    rows = {}
    emit = eng._emit_token

    def record(slot, logits):
        rows.setdefault(eng.slot_req[slot].rid, []).append(logits.copy())
        emit(slot, logits)

    eng._emit_token = record
    rng = np.random.default_rng(3)
    for rid, (n, new) in enumerate(((5, 9), (13, 3), (20, 7), (9, 5))):
        eng.submit(Request(rid=rid, prompt=rng.integers(1, 256, n).tolist(),
                           max_new_tokens=new))
    for k in PA.LAUNCHES:
        PA.LAUNCHES[k] = 0
    for _ in range(2):
        eng.step()
    eng.preempt(0)
    for _ in range(2):
        eng.step()
    eng.resume(0)
    eng.run()
    torch.cuda.synchronize()
    return rows, eng, dict(PA.LAUNCHES)


@pytest.mark.cuda
@pytest.mark.parametrize("sweep", [True, False], ids=["sweep", "per-layer"])
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "deepseek-v2-236b",
                                  "gemma2-27b", "gemma3-12b", *ZOO])
def test_captured_decode_matches_eager_bitwise(reduced_models, arch, sweep):
    """The graph replays K1/K2 (K3/K4) and the model's ops as the eager
    step runs them: every logit row, the tokens, the planes, PoolMetrics
    and the launch counts are equal, the counts one per layer and step.
    The reduced gemmas' window is 16 tokens, which request 2 (20 prompt
    tokens, 7 new) passes, so their local layers' K1/K2 skip pages; grok's
    step runs the einsum dispatch and musicgen's the sinusoidal positions
    inside the graph."""
    got, cap, launched = _capture_script(reduced_models, arch, sweep, True)
    want, eager, eager_launched = _capture_script(reduced_models, arch, sweep,
                                                  False)
    assert cap._captured is not None and eager._captured is None
    assert sorted(got) == sorted(want) == [0, 1, 2, 3]
    for rid in want:
        assert len(got[rid]) == len(want[rid])
        for g, w in zip(got[rid], want[rid]):
            np.testing.assert_array_equal(g, w)
    assert {r.rid: r.out_tokens for r in cap.requests.values()} == \
        {r.rid: r.out_tokens for r in eager.requests.values()}
    for k, plane in eager.pool.planes.items():
        assert torch.equal(cap.pool.planes[k], plane), k
    assert dataclasses.asdict(cap.pool.metrics) == \
        dataclasses.asdict(eager.pool.metrics)
    assert cap.pool.metrics.page_faults >= 1
    assert launched == eager_launched
    mla = reduced_models[arch][0].attn_type == "mla"
    key = {(False, True): "k1", (False, False): "k2", (True, True): "k3",
           (True, False): "k4"}[mla, sweep]
    layers = reduced_models[arch][0].num_layers
    assert launched[key] == layers * cap.metrics.decode_steps > 0
    assert sum(launched.values()) == launched[key]


@pytest.mark.cuda
@pytest.mark.parametrize("sweep", [True, False], ids=["sweep", "per-layer"])
def test_captured_decode_refuses_moved_planes_and_host_reads(reduced_models,
                                                            sweep):
    cfg, params = reduced_models["qwen3-1.7b"]
    engine_cfg = PagedEngineConfig(batch_slots=2, max_seq=64, page_tokens=8,
                                   prefill_buckets=(8, 16), sweep_decode=sweep,
                                   device="cuda")
    eng = PagedServingEngine(cfg, params, engine_cfg)
    eng.submit(Request(rid=0, prompt=[5] * 11, max_new_tokens=6))
    eng.step()
    assert eng._captured is not None
    key = next(iter(eng.pool.planes))
    eng.pool.planes[key] = eng.pool.planes[key].clone()
    with pytest.raises(RuntimeError, match="reallocated"):
        eng.step()
    # a step that reads the device back is refused at capture, by its op
    eng = PagedServingEngine(cfg, params, engine_cfg)
    step = eng._device_step
    eng._device_step = lambda: (step(), step()[0].sum().item())[0]
    eng.submit(Request(rid=0, prompt=[5] * 11, max_new_tokens=6))
    with pytest.raises(StepNotCapturable, match="_local_scalar_dense"):
        eng.step()


# ------------------------------------- shadow_check and the serving benchmarks
@pytest.mark.cuda
@pytest.mark.parametrize("sweep", [True, False], ids=["sweep", "per-layer"])
def test_shadow_check_on_the_captured_step(reduced_models, sweep):
    """shadow_check on the captured K1 (K2) step: the checker consumes the
    pool's trace after every replay and finds nothing under preemption
    pressure (evictions, swap-out, resume restores); a planted corruption
    of the trace fails the next tick."""
    from repro_torch.analysis import EventKind, LifecycleViolationError

    cfg, params = reduced_models["qwen3-1.7b"]
    eng = PagedServingEngine(cfg, params, PagedEngineConfig(
        batch_slots=2, max_seq=64, page_tokens=8, prefill_buckets=(8, 16, 32),
        policy="priority", sweep_decode=sweep, shadow_check=True,
        device="cuda"))
    rng = np.random.default_rng(0)
    for rid, n in enumerate((9, 7)):
        eng.submit(Request(rid=rid, prompt=rng.integers(1, 256, n).tolist(),
                           max_new_tokens=12, priority=0))
    for k in PA.LAUNCHES:
        PA.LAUNCHES[k] = 0
    for _ in range(3):
        eng.step()
    eng.submit(Request(rid=2, prompt=rng.integers(1, 256, 5).tolist(),
                       max_new_tokens=4, priority=5))
    eng.run()
    assert eng._captured is not None
    assert eng.metrics.preemptions >= 1 and eng.pool.metrics.page_faults >= 1
    assert len(eng.pool.trace) > 0 and eng._shadow_checker.violations == []
    key = "k1" if sweep else "k2"
    assert PA.LAUNCHES[key] == cfg.num_layers * eng.metrics.decode_steps > 0
    eng.submit(Request(rid=3, prompt=[5] * 6, max_new_tokens=4))
    eng.step()
    eng.pool.trace.emit(0, EventKind.UNREF, pid=999, refcount=-1)
    with pytest.raises(LifecycleViolationError, match="refcount-underflow"):
        eng.step()


@pytest.fixture(scope="module")
def full_qwen3():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    cfg = get_config("qwen3-1.7b")
    return cfg, init_params(cfg, seed=0, device="cuda")


@pytest.mark.cuda
def test_serving_slo_contract_at_full_width(full_qwen3):
    """serving_slo's three policies on full-width qwen3-1.7b, captured K1:
    the contract holds, the gate passes against the port's full-width
    baseline, and every decode step ran K1 once a layer."""
    from repro_torch.benchmarks import common, serving_slo

    cfg, params = full_qwen3
    for k in PA.LAUNCHES:
        PA.LAUNCHES[k] = 0
    policies = serving_slo.run_all(
        cfg, params, 64, path="sweep", device="cuda",
        n_params=common.n_params_of(params))
    assert serving_slo.contract_failures(policies) == []
    gate = serving_slo.evaluate_gate(
        policies, common.default_baseline("serving", reduced=False))
    assert gate["pass"], gate
    steps = sum(p["decode_steps"] for p in policies.values())
    assert PA.LAUNCHES["k1"] == cfg.num_layers * steps > 0
    assert sum(PA.LAUNCHES.values()) == PA.LAUNCHES["k1"]
