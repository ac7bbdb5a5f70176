"""The port's CUDA kernels on the card (marker `cuda`; skipped without one).

No JAX here: the machine with the card has none. Run there with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

K1/K2 are held against their plain PyTorch versions in bf16 (two bf16
ulps of each (b, h) row's largest value: the card sums in another order),
K1 == K2 bitwise, and K1's commit bitwise equal to the plain commit. Planted
faults (the last visible page of the longest row skipped, the current token
not folded) must fall outside that limit; that check also runs on the CPU.
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
