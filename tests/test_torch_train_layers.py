"""The training path's layers in the port against the reference's: the
chunked cross-entropy (value and gradients, the padded vocab rows masked,
gemma2's final softcap, a vocab that is not a multiple of the chunk, the
dense loss), the streamed attention at T = 2112 under autograd (gradients
against the reference's ``_attend_chunked``, the forward bitwise equal to
the in-place serving path), a whole model's loss and gradients at
T = 2112, remat (grads with ``cfg.remat`` equal to grads without,
bitwise, for every pattern kind), and the model's entry points
(``Model.loss``, ``num_params``, ``demo_batch``).

Inputs come from numpy seeds; with f32 on both sides the values agree
within 1e-5 relative and the gradients within F32_REL = 1e-4 of each
one's largest |value|; the reference's own test of the dense loss holds
its bf16 loss at 2e-3.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import layers as ref_layers
from repro_torch.configs import get_config
from repro_torch.launch.steps import value_and_grad
from repro_torch.models import build_model, demo_batch, init_params
from repro_torch.models import layers as L
from repro_torch.models import module as M
from repro_torch.models import transformer as T
from test_torch_ssm import _flat
from test_torch_train_grads import (
    F32_REL, LOSS_REL, close_leaf, np_batch, ref_value_and_grad, to_jax,
    to_torch, train_pair)


# ------------------------------------------------------------ chunked xent
def _xent_case(arch, vocab, chunk, seed, dtype, tie=True):
    """(reference cfg, port cfg, table, x, targets, mask) as numpy."""
    over = dict(vocab_size=vocab, vocab_chunk=chunk, tie_embeddings=tie)
    ref_cfg = dataclasses.replace(ref_get_config(arch).reduced(), **over)
    cfg = dataclasses.replace(get_config(arch).reduced(), **over)
    rng = np.random.default_rng(seed)
    D = cfg.d_model
    cast = (lambda a: torch.from_numpy(a.astype(np.float32)).to(dtype)
            .float().numpy())
    table = cast(rng.standard_normal((cfg.padded_vocab, D)) * 0.3)
    x = cast(rng.standard_normal((2, 16, D)))
    tgt = rng.integers(0, vocab, (2, 16)).astype(np.int32)
    mask = (rng.random((2, 16)) < 0.8).astype(np.float32)
    return ref_cfg, cfg, table, x, tgt, mask


@pytest.mark.parametrize("arch,vocab,chunk,tie", [
    ("qwen3-1.7b", 200, 48, True),    # 240 padded rows, the last tile 8 real
    ("qwen3-1.7b", 256, 64, False),   # the reduced tiles, an untied lm_head
    ("gemma2-27b", 200, 48, True),    # final_softcap 30 before the mask
    ("grok-1-314b", 100, 256, True)])  # one tile (vocab < chunk)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_chunked_xent_matches_reference(arch, vocab, chunk, tie, dtype):
    """The loss and its gradients with respect to the hiddens and the
    (padded) head table ("table" when tied, else "lm_head"): f32 within
    1e-5 / F32_REL, bf16 within 2e-2."""
    tdt, jdt = ((torch.float32, jnp.float32) if dtype == "f32"
                else (torch.bfloat16, jnp.bfloat16))
    ref_cfg, cfg, table, x, tgt, mask = _xent_case(arch, vocab, chunk, 0, tdt,
                                                   tie)
    key = "table" if cfg.tie_embeddings else "lm_head"

    def ref_loss(w, xx):
        return ref_layers.chunked_xent({key: w}, xx, jnp.asarray(tgt),
                                       jnp.asarray(mask), cfg=ref_cfg)
    want, (gw, gx) = jax.value_and_grad(ref_loss, argnums=(0, 1))(
        jnp.asarray(table, jdt), jnp.asarray(x, jdt))
    w = torch.from_numpy(table).to(tdt).requires_grad_(True)
    xx = torch.from_numpy(x).to(tdt).requires_grad_(True)
    got = L.chunked_xent({key: w}, xx, torch.from_numpy(tgt),
                         torch.from_numpy(mask), cfg=cfg)
    got.backward()
    got = got.detach()
    rel = 1e-5 if dtype == "f32" else 2e-2
    assert got.dtype == torch.float32
    assert abs(float(got) - float(want)) <= rel * abs(float(want))
    grel = F32_REL if dtype == "f32" else 2e-2
    close_leaf(w.grad.float().numpy(), np.asarray(gw, np.float32), grel,
               "d table")
    close_leaf(xx.grad.float().numpy(), np.asarray(gx, np.float32), grel,
               "d x")
    # the padded rows get no gradient
    assert not w.grad[vocab:].any()


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "gemma2-27b"])
def test_chunked_xent_equals_dense_loss(arch):
    """The streamed loss is the mean masked nll of the dense softcapped
    logits over the true vocab (f32)."""
    _, cfg, table, x, tgt, mask = _xent_case(arch, 200, 48, 1, torch.float32)
    got = L.chunked_xent({"table": torch.from_numpy(table)},
                         torch.from_numpy(x), torch.from_numpy(tgt),
                         torch.from_numpy(mask), cfg=cfg)
    logits = torch.from_numpy(x) @ torch.from_numpy(table[:200]).T
    if cfg.final_softcap is not None:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    nll = -torch.log_softmax(logits, -1).gather(
        -1, torch.from_numpy(tgt).long()[..., None])[..., 0]
    m = torch.from_numpy(mask)
    want = (nll * m).sum() / m.sum()
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))


def test_chunked_xent_keeps_no_vocab_wide_logits():
    """Each tile's logits are recomputed in the backward: the tensors
    autograd keeps are (B, S) carries and inputs, never a (B, S, C) tile."""
    _, cfg, table, x, tgt, mask = _xent_case("qwen3-1.7b", 200, 48, 0,
                                             torch.float32)
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t
    w = torch.from_numpy(table).requires_grad_(True)
    xx = torch.from_numpy(x).requires_grad_(True)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        L.chunked_xent({"table": w}, xx, torch.from_numpy(tgt),
                       torch.from_numpy(mask), cfg=cfg)
    assert saved and all(s[-1] != 48 for s in saved if len(s) == 3), saved


# ------------------------------------------------------- long attention
def _qkv(seed, T, H=4, K=2, hd=16):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((1, T, H, hd)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((1, T, K, hd)) * 0.5).astype(np.float32)
    v = rng.standard_normal((1, T, K, hd)).astype(np.float32)
    w = rng.standard_normal((1, T, H, hd)).astype(np.float32)
    return q, k, v, w


@pytest.mark.parametrize("softcap,window", [(None, None), (30.0, 300)])
def test_streamed_attention_grads_match_reference(softcap, window):
    """`_attend_chunked` at T = 2112 (three KV blocks, the last one 64
    rows) under autograd: the output and the gradients of sum(out * w)
    with respect to q, k and v against the reference's."""
    T_ = 2112
    q, k, v, w = _qkv(3, T_)
    kw = dict(softcap=softcap, scale=0.25, window=window)

    def ref(q, k, v):
        return jnp.sum(ref_layers._attend_chunked(q, k, v, **kw) * w)
    want_grads = jax.grad(ref, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want_out = np.asarray(ref_layers._attend_chunked(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = L._attend_chunked(*ts, **kw)
    (out * torch.from_numpy(w)).sum().backward()
    close_leaf(out.detach().numpy(), want_out, F32_REL, "out")
    for name, t, g in zip("qkv", ts, want_grads):
        close_leaf(t.grad.numpy(), np.asarray(g), F32_REL, f"d{name}")
    # the serving (no autograd, in place) path rounds as the autograd one
    with torch.no_grad():
        served = L._attend_chunked(*(t.detach() for t in ts), **kw)
    assert torch.equal(served, out.detach())


def test_long_sequence_loss_and_grads_match_reference(monkeypatch):
    """Reduced qwen3-1.7b (f32) trained on one sequence of 2112 tokens: the
    attention takes `_attend_chunked` (counted), and the loss and every
    gradient leaf agree with the reference's."""
    ref_cfg, ref_params, cfg, params = train_pair("qwen3-1.7b", True)
    batch = np_batch(cfg, b=1, s=2112, seed=4)
    want_loss, want_grads = ref_value_and_grad(ref_cfg)(ref_params,
                                                        to_jax(batch))
    calls = []
    streamed = L._attend_chunked
    monkeypatch.setattr(L, "_attend_chunked",
                        lambda *a, **kw: calls.append(1) or streamed(*a, **kw))
    loss, grads = value_and_grad(cfg)(params, to_torch(batch))
    # two groups, each run forward and again in its remat backward
    assert len(calls) == 2 * cfg.num_layers
    assert abs(float(loss) - float(want_loss)) <= LOSS_REL * abs(
        float(want_loss))
    want_grads = _flat(want_grads)
    for path, g in M.flatten(grads):
        close_leaf(g.numpy(), want_grads[path], F32_REL, path)


# ------------------------------------------------------------------ remat
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "gemma3-12b", "grok-1-314b",
                                  "deepseek-v2-236b", "rwkv6-7b",
                                  "zamba2-7b"])
@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
def test_remat_grads_equal_plain_grads_bitwise(arch, f32):
    """One torch.utils.checkpoint per group (the reference's remat policy)
    changes no bit of the loss or of any gradient: the recomputed forward
    is the same program, and the carried MoE aux goes through it too."""
    _, _, cfg, params = train_pair(arch, f32)
    batch = to_torch(np_batch(cfg))
    l1, g1 = value_and_grad(dataclasses.replace(cfg, remat=True))(params,
                                                                  batch)
    l2, g2 = value_and_grad(dataclasses.replace(cfg, remat=False))(params,
                                                                   batch)
    assert torch.equal(l1, l2)
    for (path, a), (_, b) in zip(M.flatten(g1), M.flatten(g2)):
        assert torch.equal(a, b), path


def test_remat_keeps_only_group_carries():
    """Under remat the tensors autograd keeps between the layers are the
    groups' inputs: without it, each layer's activations are kept, and
    many more tensors are saved."""
    _, _, cfg, params = train_pair("qwen3-1.7b", True)
    batch = to_torch(np_batch(cfg))

    def count(c):
        n = [0]

        def pack(t):
            n[0] += 1
            return t
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in M.flatten(params)}
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            x, pos = T._embed_inputs(M.unflatten(leaves), batch["tokens"], c)
            T.train_backbone(M.unflatten(leaves), x, pos, cfg=c)
        return n[0]
    assert count(cfg) * 4 < count(dataclasses.replace(cfg, remat=False))


# ---------------------------------------------------------- entry points
def test_model_loss_num_params_demo_batch():
    cfg = get_config("musicgen-large").reduced()
    model = build_model(cfg, seed=0, device="cpu")
    batch = demo_batch(cfg, 2, 16, device="cpu")
    assert batch["tokens"].dtype == torch.int32
    assert torch.equal(batch["targets"], torch.roll(batch["tokens"], -1, 1))
    assert batch["frontend_embeds"].shape == (2, cfg.frontend_tokens,
                                              cfg.d_model)
    assert batch["frontend_embeds"].dtype == torch.bfloat16
    with torch.no_grad():
        loss = model.loss(batch)
    assert torch.isfinite(loss) and abs(float(loss) - np.log(
        cfg.vocab_size)) < 1.0
    assert model.num_params() == sum(p.numel() for _, p in
                                     M.flatten(model.params))
    # the same seed gives the same batch
    again = demo_batch(cfg, 2, 16, device="cpu")
    assert all(torch.equal(batch[k], again[k]) for k in batch)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "deepseek-v2-236b",
                                  "zamba2-7b"])
def test_train_kind_equals_prefill_math(arch):
    """The train kind's backbone is prefill's without the caches: the
    final hiddens through the port's prefill logits path agree bitwise."""
    cfg = get_config(arch).reduced()
    params = init_params(cfg, seed=1, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32))
    with torch.no_grad():
        x, pos = T._embed_inputs(params, toks, cfg)
        h, _ = T.train_backbone(params, x, pos, cfg=cfg)
        want, _ = T.prefill_fn(params, toks, cfg=cfg)
    got = L.logits_apply(params["embedding"], h[:, -1:], cfg=cfg)[:, 0]
    assert torch.equal(got, want)
