"""How far the port's whole prefill drifts from the reference's with depth,
and whether the drift is the two frameworks' bf16 rounding.

For each reduced model (window 16) at the given depth, bridged from the
reference's init as in test_torch_local_attention, one prefill of a
40-token bucket (rows of 40 and 27 tokens) on both sides, in bf16 and
with the weights (so the activations) in f32 on both sides; the caches are
stored in bf16 either way. Prints, per model, type and sandwich-norm
setting, max |port - reference| over max |reference| of the logits and of
every layer's K/V cache, in layer order.

    PYTHONPATH=src python tests/torch_depth_drift.py --layers 12
    PYTHONPATH=src python tests/torch_depth_drift.py --layers 12 \\
        --no-sandwich --archs gemma2-27b gemma3-12b
"""
import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models import module as M
from repro_torch.models.bridge import params_from_reference
from test_torch_local_attention import ARCHS, S, _flat, _np, _tokens


def drift(arch, layers, f32, sandwich):
    over = dict(num_layers=layers)
    if not sandwich:
        over["sandwich_norm"] = False
    ref_cfg = dataclasses.replace(ref_get_config(arch).reduced(),
                                  paged_kv=True, **over)
    cfg = dataclasses.replace(get_config(arch).reduced(), paged_kv=True,
                              **over)
    ref_params = ref_build_model(ref_cfg).init(jax.random.PRNGKey(0))
    params = params_from_reference(_flat(ref_params), cfg, device="cpu")
    if f32:
        ref_params = jax.tree.map(lambda a: a.astype(jnp.float32), ref_params)
        params = M.unflatten({k: v.float() for k, v in M.flatten(params)})
    lens = np.asarray([40, 27], np.int32)
    toks = _tokens(cfg, 40, lens)
    want_logits, want = jax.jit(ref_build_model(ref_cfg).prefill,
                                static_argnames=("max_seq",))(
        ref_params, {"tokens": jnp.asarray(toks),
                     "lengths": jnp.asarray(lens)}, max_seq=S)
    got_logits, got = build_model(cfg, params).prefill(
        torch.as_tensor(toks, dtype=torch.long), torch.as_tensor(lens),
        max_seq=S)
    rel = lambda g, w: float(np.abs(g - w).max() / np.abs(w).max())
    want_logits = np.asarray(want_logits, np.float32)
    per_layer = []
    for g in range(cfg.num_groups):
        for key in sorted(want["groups"], key=lambda k: int(k.split(":")[0])):
            per_layer.append(max(
                rel(got["groups"][key][leaf][g].float().numpy(),
                    _np(want["groups"][key][leaf][g])) for leaf in "kv"))
    return rel(got_logits.float().numpy(), want_logits), per_layer


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--archs", nargs="+", default=list(ARCHS))
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--no-sandwich", action="store_true",
                    help="also run each sandwich-normed model without")
    args = ap.parse_args()
    for arch in args.archs:
        sandwiches = [True]
        if args.no_sandwich and get_config(arch).sandwich_norm:
            sandwiches.append(False)
        for sandwich in sandwiches:
            for f32 in (False, True):
                logits, caches = drift(arch, args.layers, f32, sandwich)
                print(f"{arch} {args.layers} layers, "
                      f"{'f32' if f32 else 'bf16'} weights"
                      f"{'' if sandwich else ', no sandwich norms'}: logits "
                      f"{logits:.4f}, caches max {max(caches):.4f}, by layer "
                      + " ".join(f"{e:.4f}" for e in caches), flush=True)


if __name__ == "__main__":
    main()
