"""The port's CUDA kernels on the card (marker `cuda`; skipped without one).

No JAX here: the machine with the card has none. Run there with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The gather K5 is held against its plain version bitwise (it moves bytes),
in f32, bf16 and int32 and at the two serving page geometries, and so is
the filter K9 in both modes and at both unload distances. The SUM K8 is
held exactly to the fp64 sum on values that make every order exact, and to
the reference's tolerance on normal values; the matmul K10 to the
reference's tolerances. K1/K2 and
the MLA pair K3/K4 are held against their plain PyTorch versions
in bf16 (two bf16 ulps of each (b, h) row's largest value: the card sums in
another order), K1 == K2 and K3 == K4 bitwise, and the sweep kernels'
commits bitwise equal to the plain commits. Planted faults (the last visible
page of the longest row skipped, the current token not folded) must fall
outside that limit; that check also runs on the CPU. The dense attention
pair, K7 (flash attention) and K6 (decode over a dense cache), is held the
same way in bf16 and to rtol = atol = 3e-4 in f32, at d = 1 and 4 in both
issue orders, with its own planted faults (the last KV chunk lost, the
softcap dropped).
"""
import dataclasses
import importlib

import numpy as np
import pytest
import torch

from repro_torch.core import IssueStrategy, PULConfig
from repro_torch.kernels import ops
from repro_torch.kernels.pul_decode import (
    decode_attention_kernel_ref,
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
    # deepseek-v2 width: 128 heads in 16 blocks of 8, kv_lora 512, rope 64
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


# (n_pages, P, F) at the serving geometries, cut to a few frames: full-width
# qwen3-1.7b (28 layers x 2 x 8 x 128) and deepseek-v2 at six layers
# (6 x 576, the ragged last tile)
GATHER_CASES = {"qwen3": (6, 16, 57344), "deepseek": (9, 16, 3456)}


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


@pytest.mark.cuda
@pytest.mark.parametrize("rows,width", [(128, 64), (64, 32), (128, 16),
                                        (96, 4)])
@pytest.mark.parametrize("unload_distance", [0, 1, 3])
@pytest.mark.parametrize("cfg", MICRO_CFGS[1:3] + [PULConfig(distance=8)],
                         ids=["d4", "d3-seq", "d8"])
@pytest.mark.parametrize("materialize", [False, True])
def test_filter_kernel_matches_plain_version(dev, materialize, cfg,
                                             unload_distance, rows, width):
    rng = np.random.default_rng(1)
    data = _eighths(rng, (rows * 40, width), dev)     # ties at 0.25 included
    cfg = dataclasses.replace(cfg, unload_distance=unload_distance)
    got = pul_filter(data, 0.25, cfg=cfg, rows_per_block=rows,
                     materialize=materialize)
    torch.cuda.synchronize()
    want = (filter_materialize_ref(data, 0.25) if materialize
            else filter_ref(data, 0.25))
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(_words(got), _words(want))


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
        pul_filter(data.bfloat16(), 0.0, rows_per_block=32)
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
