"""The port's optimizer against the reference's: one AdamW update given
the reference's gradients and state (``opt_state_from_reference``), with
fp32 moments (qwen3-1.7b) and bf16 moments (deepseek-v2-236b's
``bf16_moments``), the global-norm clip and the cosine schedule; the
weight-decay quirk of stacked parameters pinned on both packages; the int8
quantization and its error-feedback form.

New parameters, m and v are held within one ulp of their type (fp32, or
bf16 where they are stored so) where the two frameworks run the same fp32
element-wise ops on the same inputs; the global norm's reduction order
and what it moves through the clip scale have their own bounds (see the
test), and the schedule's transcendental ops are held at one ulp.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import OptimizerConfig as RefOptimizerConfig
from repro.optim import adamw_init as ref_adamw_init
from repro.optim import adamw_update as ref_adamw_update
from repro.optim import compression as ref_C
from repro.optim import cosine_schedule as ref_cosine_schedule
from repro_torch.models import module as M
from repro_torch.models.bridge import opt_state_from_reference
from repro_torch.optim import (
    OptimizerConfig, adamw_init, adamw_update, compression as C,
    cosine_schedule, global_norm)
from test_torch_ssm import _flat
from test_torch_train_grads import (
    np_batch, ref_value_and_grad, to_jax, train_pair)

OPT = dict(lr=1e-2, warmup_steps=2, total_steps=10)
ULPS_NORM = 4
ULPS_CLIPPED = 8
ULPS_SCHEDULE = 2


def _ulp(want: np.ndarray, bits: int) -> np.ndarray:
    """One ulp of each value in a float type with `bits` mantissa bits
    (23: fp32, 7: bf16); the smallest normal's at zero."""
    a = np.maximum(np.abs(want.astype(np.float64)), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(a)) - bits)


def _within_ulp(got, want, bits, what, ulps=1.0):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = np.abs(got - want) / _ulp(want, bits)
    assert err.max() <= ulps, f"{what}: {err.max():.2f} ulps"


def _bits(t: torch.Tensor) -> int:
    return 7 if t.dtype == torch.bfloat16 else 23


@pytest.mark.parametrize("clip", ["off", "on"])
@pytest.mark.parametrize("arch,moments", [
    ("qwen3-1.7b", "f32"), ("deepseek-v2-236b", "bf16")])
def test_adamw_update_matches_reference(arch, moments, clip):
    """One update from step 3 (warmup done, the cosine under way), with the
    reference's gradients of one batch (bf16 and fp32 leaves) and m, v
    drawn from a numpy seed; the reference runs op by op (its jit fuses the
    schedule's ops and rounds lr one ulp away from them).

    clip "off" (clip_norm 1e9, the scale exactly 1): new params, m and v
    within one ulp of their type. clip "on" (clip_norm 1, the batch's norm
    ~3.4): the global norm sums ~10^5 squares in another order and lands
    within ULPS_NORM = 4 fp32 ulps of the reference's; the clip scale then
    carries that difference into every element (bound below)."""
    ref_cfg, ref_params, cfg, params = train_pair(arch, False)
    _, grads = ref_value_and_grad(ref_cfg)(ref_params, to_jax(np_batch(cfg)))
    mdt, tdt = ((jnp.float32, torch.float32) if moments == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    rng = np.random.default_rng(7)
    ref_state = ref_adamw_init(ref_params, mdt)
    ref_state = {
        "m": jax.tree.map(lambda z: jnp.asarray(
            rng.standard_normal(z.shape) * 1e-3, jnp.float32).astype(mdt),
            ref_state["m"]),
        "v": jax.tree.map(lambda z: jnp.asarray(
            rng.random(z.shape) * 1e-5, jnp.float32).astype(mdt),
            ref_state["v"]),
        "step": jnp.int32(3)}
    opt = dict(OPT, clip_norm=1e9 if clip == "off" else 1.0)
    want_p, want_s, want_metrics = ref_adamw_update(
        grads, ref_state, ref_params, RefOptimizerConfig(**opt))

    state = opt_state_from_reference(_flat(ref_state["m"]),
                                     _flat(ref_state["v"]), 3, cfg,
                                     moment_dtype=tdt, device="cpu")
    dtypes = {k: v.dtype for k, v in M.flatten(params)}
    tgrads = M.unflatten({k: torch.from_numpy(np.array(v)).to(dtypes[k])
                          for k, v in _flat(grads).items()})
    got_p, got_s, metrics = adamw_update(tgrads, state, params,
                                         OptimizerConfig(**opt))
    assert int(got_s["step"]) == 4 and got_s["step"].dtype == torch.int32
    assert float(want_metrics["grad_norm"]) > 1.0
    _within_ulp(float(metrics["grad_norm"]),
                float(want_metrics["grad_norm"]), 23, "grad_norm",
                ULPS_NORM)
    _within_ulp(float(metrics["lr"]), float(want_metrics["lr"]), 23, "lr")
    for name, got, want in (("params", got_p, _flat(want_p)),
                            ("m", got_s["m"], _flat(want_s["m"])),
                            ("v", got_s["v"], _flat(want_s["v"]))):
        for path, t in M.flatten(got):
            assert t.dtype == (dtypes[path] if name == "params" else tdt)
            what = f"{name} {path}"
            if clip == "off":
                _within_ulp(t.float().numpy(), want[path], _bits(t), what)
                continue
            # an element where b1 * m and (1 - b1) * g nearly cancel keeps
            # the scale's absolute error, not its relative one: held to one
            # ulp of its own type or ULPS_CLIPPED fp32 ulps of the leaf's
            # largest |value|
            err = np.abs(t.float().numpy().astype(np.float64) - want[path])
            bound = np.maximum(_ulp(want[path], _bits(t)), ULPS_CLIPPED
                               * _ulp(np.abs(want[path]).max(), 23))
            assert (err <= bound).all(), (what, (err / bound).max())


def test_weight_decay_follows_the_stacked_ndim_quirk():
    """Decay skips tensors with ndim <= 1, as in the reference: a group's
    norm scales are stacked over the groups (2-D) and decay, the dense
    layer's norms and final_norm (1-D) do not. Zero gradients at step 1
    make the update the decay alone; both packages agree leaf by leaf."""
    ref_cfg, ref_params, cfg, params = train_pair("deepseek-v2-236b", False)
    ocfg = dict(lr=0.5, warmup_steps=0, total_steps=10, weight_decay=0.1)
    zeros = M.unflatten({k: torch.zeros_like(v) for k, v in
                         M.flatten(params)})
    new, _, _ = adamw_update(zeros, adamw_init(params), params,
                             OptimizerConfig(**ocfg))
    want, _, _ = ref_adamw_update(
        jax.tree.map(jnp.zeros_like, ref_params), ref_adamw_init(ref_params),
        ref_params, RefOptimizerConfig(**ocfg))
    want = _flat(want)
    old, new = dict(M.flatten(params)), dict(M.flatten(new))
    decayed = {k for k in old if not torch.equal(old[k], new[k])}
    assert decayed == {k for k, v in old.items() if v.dim() > 1}
    for k in ("groups/0:moe/norm1", "groups/0:moe/attn/q_norm"):
        assert old[k].dim() == 2 and k in decayed
    for k in ("dense/0/norm1", "dense/0/attn/kv_norm", "final_norm"):
        assert old[k].dim() == 1 and k not in decayed
    for k in old:
        np.testing.assert_array_equal(new[k].float().numpy(), want[k],
                                      err_msg=k)
        assert (k in decayed) == (not np.array_equal(
            want[k], old[k].float().numpy()))


def test_adamw_first_step_is_the_sign():
    """The reference's test_adamw_matches_reference_step: at step 1 with no
    decay or clip, mhat = g and vhat = g^2, so each parameter moves by
    -lr(1) (x sign(g))."""
    params = {"w": torch.ones((4, 4), dtype=torch.bfloat16),
              "b": torch.zeros(4)}
    grads = {"w": torch.full((4, 4), 0.5), "b": torch.ones(4)}
    cfg = OptimizerConfig(lr=1e-2, warmup_steps=0, total_steps=10,
                          weight_decay=0.0, clip_norm=1e9)
    new_p, new_s, metrics = adamw_update(grads, adamw_init(params), params,
                                         cfg)
    lr1 = float(cosine_schedule(cfg, 1))
    np.testing.assert_allclose(new_p["b"].numpy(), -lr1 * np.ones(4),
                               rtol=1e-4)
    assert new_p["w"].dtype == torch.bfloat16
    assert int(metrics["step"]) == 1 and int(new_s["step"]) == 1
    assert new_s["m"]["w"].dtype == torch.float32


def test_grad_clipping_matches_reference():
    """A gradient of norm ~283 is clipped to clip_norm: the reported norm
    is the unclipped one, and the update equals the reference's."""
    params = {"w": torch.zeros(8)}
    big = {"w": torch.full((8,), 100.0)}
    cfg = dict(lr=1.0, clip_norm=1.0, warmup_steps=0, weight_decay=0.0)
    new, state, metrics = adamw_update(big, adamw_init(params), params,
                                       OptimizerConfig(**cfg))
    ref_p = {"w": jnp.zeros(8)}
    want, want_s, want_m = ref_adamw_update(
        {"w": jnp.full((8,), 100.0)}, ref_adamw_init(ref_p), ref_p,
        RefOptimizerConfig(**cfg))
    assert float(metrics["grad_norm"]) > 100
    _within_ulp(float(metrics["grad_norm"]), float(want_m["grad_norm"]), 23,
                "norm")
    _within_ulp(state["m"]["w"].numpy(), np.asarray(want_s["m"]["w"]), 23,
                "m")
    _within_ulp(new["w"].numpy(), np.asarray(want["w"]), 23, "w")
    # clipped: m = (1 - b1) * g * clip / |g|
    np.testing.assert_allclose(state["m"]["w"].numpy(),
                               0.1 * 100.0 / float(metrics["grad_norm"]),
                               rtol=1e-5)


def test_global_norm_matches_reference():
    rng = np.random.default_rng(3)
    tree = {"a": rng.standard_normal((5, 7)).astype(np.float32),
            "b": {"c": rng.standard_normal(11).astype(np.float32)}}
    got = global_norm(M.unflatten({k: torch.from_numpy(v) for k, v in
                                   M.flatten(tree)}))
    want = ref_C.jnp.sqrt(sum(jnp.sum(jnp.square(jnp.asarray(v)))
                              for _, v in M.flatten(tree)))
    _within_ulp(float(got), float(want), 23, "norm")


@pytest.mark.parametrize("warmup,total", [(5, 15), (0, 10), (100, 10_000)])
def test_cosine_schedule_matches_reference(warmup, total):
    """Warmup, cosine and the floor of min_lr_ratio, step by step, within
    ULPS_SCHEDULE = 2 fp32 ulps: torch's and XLA's fp32 cos are each
    within about an ulp of the true value, not equal to each other."""
    cfg = dict(lr=3e-4, warmup_steps=warmup, total_steps=total)
    for step in list(range(0, 25)) + [total // 2, total, total + 50]:
        got = float(cosine_schedule(OptimizerConfig(**cfg), step))
        want = float(ref_cosine_schedule(RefOptimizerConfig(**cfg),
                                         jnp.int32(step)))
        _within_ulp(got, want, 23, f"lr({step})", ULPS_SCHEDULE)
    last = float(cosine_schedule(OptimizerConfig(**cfg), total + 50))
    assert abs(last - 0.1 * 3e-4) < 1e-9


def test_adamw_init_layout():
    _, _, cfg, params = train_pair("qwen3-1.7b", False)
    st = adamw_init(params, torch.bfloat16)
    assert set(st) == {"m", "v", "step"} and int(st["step"]) == 0
    for (path, p), (_, m) in zip(M.flatten(params), M.flatten(st["m"])):
        assert m.shape == p.shape and m.dtype == torch.bfloat16 and not m.any()


# ------------------------------------------------------------ compression
@pytest.mark.parametrize("seed", range(6))
def test_quantize_int8_matches_reference(seed):
    """q bitwise (round half to even, clip at 127) and the scale; an
    all-zero tensor takes scale 1; the round trip within scale / 2."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(257) * 10 ** rng.uniform(-3, 3)).astype(
        np.float32)
    if seed == 0:
        x[:] = 0.0
    if seed == 1:
        x[:4] = [2.5, -2.5, 0.5, 1.5]            # ties after the scale
        x[4] = 127.0 * 4
    q, s = C.quantize_int8(torch.from_numpy(x))
    wq, ws = ref_C.quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(wq))
    assert float(s) == float(ws)
    err = np.abs(C.dequantize_int8(q, s).numpy() - x)
    assert err.max() <= float(s) / 2 + 1e-6


def test_ef_quantize_matches_reference():
    """Fifty error-feedback steps on the same gradient: q, scale and the
    carried error equal the reference's; the cumulative quantized sum
    tracks the true one better than independent quantization (the
    reference's test_error_feedback_reduces_bias)."""
    g = (np.random.default_rng(0).standard_normal(256) * 0.01).astype(
        np.float32)
    tg = torch.from_numpy(g)
    err = C.init_error_state({"g": tg})["g"]
    werr = jnp.zeros(256, jnp.float32)
    acc_ef, acc_naive = torch.zeros(256), torch.zeros(256)
    for _ in range(50):
        q, s, err = C.ef_quantize(tg, err)
        wq, ws, werr = ref_C.ef_quantize(jnp.asarray(g), werr)
        np.testing.assert_array_equal(q.numpy(), np.asarray(wq))
        assert float(s) == float(ws)
        np.testing.assert_allclose(err.numpy(), np.asarray(werr), rtol=0,
                                   atol=1e-9)
        acc_ef += C.dequantize_int8(q, s)
        acc_naive += C.dequantize_int8(*C.quantize_int8(tg))
    true = tg * 50
    assert (torch.linalg.norm(acc_ef - true)
            <= torch.linalg.norm(acc_naive - true) + 1e-5)
