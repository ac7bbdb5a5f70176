"""The port's training loss and its gradients against the reference's
``jax.value_and_grad(model.loss)``, for the reduced attention models with
their layer pattern twice over: qwen3-1.7b, qwen2.5-32b, gemma2-27b,
gemma3-12b, internvl2-2b and musicgen-large (the recurrent and MoE models
are in test_torch_train_grads_zoo.py).

The reference's init is bridged into the port (``params_from_reference``)
with the leaves it sets constant (norm scales, biases, LoRA B) redrawn from
a numpy seed on both sides (``test_torch_ssm.make_pair``), so that every
leaf carries gradient; both sides take one numpy batch (a loss mask with
zeros, the frontend stub's embeddings where the model has a frontend).
With f32 weights on both sides the loss agrees within LOSS_REL = 1e-5
relative and every gradient leaf within F32_REL = 1e-4 of that leaf's
largest |gradient|; qwen3-1.7b also runs in bf16, where the gradients are
held to REL = 2e-2 (the reference kernels' tolerance) of the exact (f32)
gradient and to 2 * REL of the reference's bf16 gradient, and the loss to
BF16_LOSS_REL = 2e-4 (see the test). Both sides remat
(``cfg.remat``, the default).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import build_model as ref_build_model
from repro_torch.launch.steps import value_and_grad
from repro_torch.models import module as M
from test_torch_ssm import _flat, make_pair

LOSS_REL = 1e-5
F32_REL = 1e-4
REL = 2e-2
BF16_LOSS_REL = 2e-4
ATTENTION_ARCHS = ("qwen3-1.7b", "qwen2.5-32b", "gemma2-27b", "gemma3-12b",
                   "internvl2-2b", "musicgen-large")


@functools.lru_cache(maxsize=None)
def train_pair(arch, f32=True):
    """(reference config, reference params, port config, port params): the
    reduced model two groups deep (deepseek-v2: its dense layer and two MoE
    groups), constant leaves redrawn, bridged; with `f32` both sides' bf16
    weights cast to f32 (one reference init serves both)."""
    if f32:
        ref_cfg, ref_params, cfg, params = train_pair(arch, False)
        return (ref_cfg, jax.tree.map(lambda a: a.astype(jnp.float32),
                                      ref_params),
                cfg, M.unflatten({k: v.float() for k, v in M.flatten(params)}))
    return make_pair(arch, 3 if arch == "deepseek-v2-236b" else 2)


def np_batch(cfg, b=2, s=16, seed=0):
    """A training batch in numpy: random tokens and targets, a loss mask
    with some zeros, and the frontend stub's embeddings (values a bf16
    holds exactly, so both packages see the same ones)."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
             "targets": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
             "loss_mask": (rng.random((b, s)) < 0.85).astype(np.float32)}
    if cfg.frontend and cfg.frontend_tokens:
        fe = rng.standard_normal((b, cfg.frontend_tokens, cfg.d_model)) * 0.02
        batch["frontend_embeds"] = torch.from_numpy(fe.astype(np.float32)).to(
            torch.bfloat16).float().numpy()
    return batch


def to_jax(batch):
    out = {k: jnp.asarray(v) for k, v in batch.items()}
    if "frontend_embeds" in out:
        out["frontend_embeds"] = out["frontend_embeds"].astype(jnp.bfloat16)
    return out


def to_torch(batch, device="cpu"):
    out = {k: torch.from_numpy(np.asarray(v)).to(device)
           for k, v in batch.items()}
    if "frontend_embeds" in out:
        out["frontend_embeds"] = out["frontend_embeds"].to(torch.bfloat16)
    return out


@functools.lru_cache(maxsize=None)
def ref_value_and_grad(ref_cfg):
    return jax.jit(jax.value_and_grad(ref_build_model(ref_cfg).loss))


def close_leaf(got, want, rel, what):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    bound = rel * np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= bound, f"{what}: max|diff| {err} > {bound}"


def check_loss_and_grads(arch, f32, rel, loss_rel=LOSS_REL):
    ref_cfg, ref_params, cfg, params = train_pair(arch, f32)
    batch = np_batch(cfg)
    want_loss, want_grads = ref_value_and_grad(ref_cfg)(ref_params,
                                                        to_jax(batch))
    want_grads = _flat(want_grads)
    loss, grads = value_and_grad(cfg)(params, to_torch(batch))
    assert loss.dtype == torch.float32 and loss.shape == ()
    assert abs(float(loss) - float(want_loss)) <= loss_rel * abs(
        float(want_loss)), (float(loss), float(want_loss))
    flat = dict(M.flatten(grads))
    assert set(flat) == set(want_grads)
    for path, g in flat.items():
        assert g.dtype == dict(M.flatten(params))[path].dtype, path
        assert np.abs(want_grads[path]).max() > 0, f"{path}: no gradient"
        close_leaf(g.float().numpy(), want_grads[path], rel, path)


@pytest.mark.parametrize("arch", ATTENTION_ARCHS)
def test_loss_and_grads_match_reference_f32(arch):
    check_loss_and_grads(arch, True, F32_REL)


def test_loss_and_grads_match_reference_bf16():
    """qwen3-1.7b with the reference's bf16 weights. A bf16 program's
    gradients are some way from the exact ones, in either framework: on
    this batch the reference's are up to 2.35 % of a leaf's largest value
    from the f32 gradient, the port's 1.76 %, in other places. So the
    port's bf16 gradients are held within REL = 2e-2 of the f32 gradient
    of the same weights (which the port and the reference share within
    1e-4: the f32 tests), and within 2 * REL of the reference's bf16
    gradients (2.23 % apart here); the loss within BF16_LOSS_REL of the
    reference's bf16 loss."""
    ref_cfg, ref_params, cfg, params = train_pair("qwen3-1.7b", False)
    _, _, _, params32 = train_pair("qwen3-1.7b", True)
    batch = np_batch(cfg)
    want_loss, want_grads = ref_value_and_grad(ref_cfg)(ref_params,
                                                        to_jax(batch))
    want_grads = _flat(want_grads)
    loss, grads = value_and_grad(cfg)(params, to_torch(batch))
    _, exact = value_and_grad(cfg)(params32, to_torch(batch))
    assert abs(float(loss) - float(want_loss)) <= BF16_LOSS_REL * abs(
        float(want_loss)), (float(loss), float(want_loss))
    exact, dtypes = dict(M.flatten(exact)), dict(M.flatten(params))
    for path, g in M.flatten(grads):
        assert g.dtype == dtypes[path].dtype, path
        close_leaf(g.float().numpy(), exact[path].numpy(), REL,
                   f"{path} vs f32")
        close_leaf(g.float().numpy(), want_grads[path], 2 * REL,
                   f"{path} vs the reference's bf16")


def test_params_stay_gradient_free():
    """value_and_grad leaves the caller's tensors as they were: none
    requires grad afterwards, and none has a .grad (serving shares them)."""
    _, _, cfg, params = train_pair("qwen3-1.7b", True)
    value_and_grad(cfg)(params, to_torch(np_batch(cfg)))
    for path, p in M.flatten(params):
        assert not p.requires_grad and p.grad is None, path
