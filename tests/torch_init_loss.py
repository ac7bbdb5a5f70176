"""The loss of the random init at qwen3-1.7b's full width, by depth, in
the reference and in the port (a script, not a test; CPU, JAX and torch).

    PYTHONPATH=src python tests/torch_init_loss.py --layers 2 16 20

Both packages draw their own random weights from seed 0 by the same rules
(the port's numbers differ, its distributions do not) and take one
TokenPipeline batch (B 1 x S 256, seed 0: the same tokens in both). The
reference's init lets a stacked kernel's fan-in span the layer axis, so
the loss at init moves with depth; it is well above ln(vocab) = 11.93 at
20 layers. Prints one line a depth. About 40 s and 9 GB of memory at 20
layers.
"""
import argparse
import dataclasses
import math
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.data import DataConfig as RefDataConfig  # noqa: E402
from repro.data import TokenPipeline as RefTokenPipeline  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--layers", type=int, nargs="+", default=[2, 16, 20])
    args = ap.parse_args()
    for n in args.layers:
        ref_cfg = dataclasses.replace(ref_get_config(args.arch),
                                      num_layers=n)
        cfg = dataclasses.replace(get_config(args.arch), num_layers=n)
        kw = dict(global_batch=1, seq_len=256, vocab_size=cfg.vocab_size)
        ref_batch = RefTokenPipeline(RefDataConfig(**kw))._host_batch(0)
        model = ref_build_model(ref_cfg)
        ref_params = model.init(jax.random.PRNGKey(0))
        ref_loss = float(jax.jit(model.loss)(
            ref_params, {k: jnp.asarray(v) for k, v in ref_batch.items()}))
        del ref_params
        params = init_params(cfg, seed=0, device="cpu")
        batch = next(TokenPipeline(DataConfig(**kw), device="cpu"))
        with torch.no_grad():
            loss = float(T.loss_fn(params, batch, cfg=cfg))
        del params
        print(f"{args.arch} at {n} layers: loss at init {ref_loss:.4f} "
              f"(reference), {loss:.4f} (port); ln(vocab) "
              f"{math.log(cfg.vocab_size):.4f}")


if __name__ == "__main__":
    main()
