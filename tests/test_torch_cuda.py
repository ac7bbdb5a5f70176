"""The port's CUDA kernels on the card (marker `cuda`; skipped without one).

No JAX here: the machine with the card has none. Run there with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

K1/K2 and the MLA pair K3/K4 are held against their plain PyTorch versions
in bf16 (two bf16 ulps of each (b, h) row's largest value: the card sums in
another order), K1 == K2 and K3 == K4 bitwise, and the sweep kernels'
commits bitwise equal to the plain commits. Planted faults (the last visible
page of the longest row skipped, the current token not folded) must fall
outside that limit; that check also runs on the CPU.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import IssueStrategy, PULConfig
from repro_torch.kernels import pul_attention as PA



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
