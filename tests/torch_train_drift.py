"""How far the port's training numbers sit from the reference's where the
tests' tolerances rest on a measurement (a script, not a test; CPU, JAX and
torch).

    PYTHONPATH=src python tests/torch_train_drift.py

Prints (1) for bridged reduced qwen3-1.7b in bf16 on the tests' batch, the
largest gradient difference, as a share of the leaf's largest |value|, of
the port's bf16 gradients and of the reference's from the f32 gradients of
the same weights, and of the two bf16 gradients from each other, and the
two bf16 losses' relative difference (test_torch_train_grads.py's bf16
case); (2) for reduced musicgen-large with f32 weights, one
make_train_step's largest update difference between the packages, as a
share of lr, at accum 1 and 4 (test_torch_train_step.py, and the card's
UPDATE_REL in chip_smoke.py). About a minute.
"""
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "src"))
sys.path.insert(0, HERE)

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.launch.steps import make_train_step as ref_make_train_step  # noqa: E402
from repro.optim import OptimizerConfig as RefOptimizerConfig  # noqa: E402
from repro.optim import adamw_init as ref_adamw_init  # noqa: E402
from repro_torch.launch.steps import make_train_step, value_and_grad  # noqa: E402
from repro_torch.models import module as M  # noqa: E402
from repro_torch.optim import OptimizerConfig, adamw_init  # noqa: E402
from test_torch_ssm import _flat  # noqa: E402
from test_torch_train_grads import (  # noqa: E402
    np_batch, ref_value_and_grad, to_jax, to_torch, train_pair)
from test_torch_train_step import LR, _jax_batch, _musicgen_batch  # noqa: E402


def _share(a, b, scale):
    return float(np.abs(np.asarray(a, np.float32)
                        - np.asarray(b, np.float32)).max() / scale)


def bf16_gradients():
    ref_cfg, ref_params, cfg, params = train_pair("qwen3-1.7b", False)
    _, ref32, _, params32 = train_pair("qwen3-1.7b", True)
    batch = np_batch(cfg)
    rl, rg = ref_value_and_grad(ref_cfg)(ref_params, to_jax(batch))
    _, rg32 = ref_value_and_grad(ref_cfg)(ref32, to_jax(batch))
    pl, pg = value_and_grad(cfg)(params, to_torch(batch))
    _, pg32 = value_and_grad(cfg)(params32, to_torch(batch))
    rg, rg32 = _flat(rg), _flat(rg32)
    pg, pg32 = dict(M.flatten(pg)), dict(M.flatten(pg32))
    worst = {"port bf16 vs port f32": 0.0, "reference bf16 vs reference f32":
             0.0, "port bf16 vs reference bf16": 0.0}
    for k in pg:
        g, g32 = pg[k].float().numpy(), pg32[k].numpy()
        pairs = {"port bf16 vs port f32": (g, g32, np.abs(g32).max()),
                 "reference bf16 vs reference f32": (rg[k], rg32[k],
                                                     np.abs(rg32[k]).max()),
                 "port bf16 vs reference bf16": (g, rg[k],
                                                 np.abs(rg[k]).max())}
        for name, (a, b, scale) in pairs.items():
            worst[name] = max(worst[name], _share(a, b, scale))
    for name, v in worst.items():
        print(f"qwen3-1.7b reduced, bf16 gradients, {name}: {100 * v:.2f} % "
              "of a leaf's largest |value|")
    print(f"qwen3-1.7b reduced, bf16 loss: port {float(pl):.7f}, reference "
          f"{float(rl):.7f}, {abs(float(pl) - float(rl)) / float(rl):.2e} "
          "relative")


def train_step_updates():
    ref_cfg, ref_params, cfg, params = train_pair("musicgen-large", True)
    batch = _musicgen_batch(cfg)
    for accum in (1, 4):
        want, _, _ = jax.jit(ref_make_train_step(
            ref_cfg, RefOptimizerConfig(lr=LR, warmup_steps=0),
            accum=accum))(ref_params, ref_adamw_init(ref_params),
                          _jax_batch(batch))
        got, _, _ = make_train_step(cfg, OptimizerConfig(
            lr=LR, warmup_steps=0), accum=accum)(params, adamw_init(params),
                                                 batch)
        want, got = _flat(want), dict(M.flatten(got))
        worst = max(_share(got[k].numpy(), want[k], LR) for k in got)
        print(f"musicgen-large reduced f32, one step at accum {accum}: "
              f"largest update difference {worst:.2e} x lr")


if __name__ == "__main__":
    bf16_gradients()
    train_step_updates()
