"""The dense yardstick of qwen3-1.7b pinned to the numbers it gave before
the dense widths, weight layout and arithmetic moved into
``families/dense_gqa.py``: the port's configuration, the weight layout and
bytes, the active parameters, a decode step's FLOPs and bytes and one K1
launch's bytes over the longctx cell's 48 contexts and over the chat
cell's first 64 prompt sizes (all of them, the first half, the first one,
none), and prefill FLOPs. Also the tiny weight tree of one seed, bit for
bit (paths, shapes, dtypes, values), and the widest logit gap of the tiny
longctx run at that seed, to the last digit."""
import hashlib
import time

import pytest
import torch

from pulbench import arith, harness, spec, traffic, weights
from pulbench.tests.tiny import tiny_cell

QWEN = spec.arch(spec.config("qwen3-1.7b"))

PORT = {"name": "qwen3-1.7b", "family": "dense", "num_layers": 28,
        "d_model": 2048, "num_heads": 16, "num_kv_heads": 8, "head_dim": 128,
        "d_ff": 6144, "vocab_size": 151936, "pattern": ("global",),
        "mlp_type": "swiglu", "qk_norm": True, "rope_theta": 1000000.0,
        "tie_embeddings": True, "norm_eps": 1e-06, "vocab_chunk": 16384}
G = "groups/0:global/"
LAYOUT = [
    ("embedding/table", (163840, 2048), "bf16"), ("final_norm", (2048,), "f32"),
    (G + "attn/k_norm", (28, 128), "f32"), (G + "attn/q_norm", (28, 128), "f32"),
    (G + "attn/wk", (28, 2048, 8, 128), "bf16"),
    (G + "attn/wo", (28, 16, 128, 2048), "bf16"),
    (G + "attn/wq", (28, 2048, 16, 128), "bf16"),
    (G + "attn/wv", (28, 2048, 8, 128), "bf16"),
    (G + "mlp/w_down", (28, 6144, 2048), "bf16"),
    (G + "mlp/w_gate", (28, 2048, 6144), "bf16"),
    (G + "mlp/w_up", (28, 2048, 6144), "bf16"),
    (G + "norm1", (28, 2048), "f32"), (G + "norm2", (28, 2048), "f32")]

LONGCTX = [4143, 4239, 4337, 4438, 4540, 4645, 4753, 4863, 4976, 5091, 5209,
           5329, 5453, 5579, 5708, 5840, 5975, 6114, 6255, 6400, 6548, 6700,
           6855, 7014, 7176, 7342, 7512, 7686, 7864, 8046, 8232, 8423, 8618,
           8818, 9022, 9231, 9444, 9663, 9887, 10116, 10350, 10589, 10835,
           11085, 11342, 11605, 11873, 12148]
CHAT = [720, 1208, 1654, 4091, 918, 738, 432, 1948, 1602, 1358, 555, 322, 824,
        1046, 2295, 506, 701, 463, 1498, 888, 1343, 1085, 333, 1272, 632, 2141,
        788, 3754, 1016, 2400, 1702, 431, 3369, 2358, 561, 838, 1216, 965, 1111,
        775, 445, 1443, 256, 2272, 1389, 1903, 652, 533, 562, 496, 648, 1004,
        3022, 1984, 907, 1351, 1125, 1177, 448, 1729, 256, 773, 2837, 1466]
CONTEXTS = {"longctx": LONGCTX, "chat": CHAT}
#: (contexts, part) -> (decode_flops, decode_bytes, attention_kernel_bytes)
TICKS = {
    ("longctx", "all"): (247270506496, 44494999552, 1466789888),
    ("longctx", "half"): (112636329984, 18468737024, 536985600),
    ("longctx", "one"): (4391436288, 3916664832, 16986112),
    ("longctx", "none"): (0, 3441397760, 0),
    ("chat", "all"): (238705213440, 12685135872, 330919936),
    ("chat", "half"): (119443554304, 8108740608, 167084032),
    ("chat", "one"): (3606282240, 3524087808, 2965504),
    ("chat", "none"): (0, 3441397760, 0),
}
PREFILL = {256: 729722388480.0, 1024: 3007216877568.0,
           4096: 13470109532160.0, 12288: 51953956028416.0}

SEED = 2**31 + 21
#: sha256 over the tiny tree's leaves in path order (each leaf's path,
#: shape, dtype and bytes)
TINY_TREE = "6a66aa1e391c6ab6a529fc0a715f7cc8e1e745c85a6f516b5af045575545ede5"
TINY_LONGCTX_GAP = 0.010193109512329102


def test_port_config_layout_and_bytes():
    assert spec.port_config(spec.config("qwen3-1.7b")) == PORT
    assert weights.layout(QWEN) == LAYOUT
    assert weights.nbytes(QWEN) == 3490156544
    assert arith.active_params(QWEN) == 1720451072
    assert arith.active_params(QWEN, head=False) == 1409286144


def test_contexts_are_the_cells():
    mix = spec.traffic("longctx_decode")
    assert traffic.quantile_sizes(mix["prompt"],
                                  mix["sessions"]).tolist() == LONGCTX
    stream = traffic.Traffic(spec.traffic("chat_closed"), 0, 300).stream()
    assert [len(next(stream).prompt) for _ in CHAT] == CHAT


@pytest.mark.parametrize("key", list(TICKS), ids="-".join)
def test_decode_tick(key):
    ctx = CONTEXTS[key[0]]
    ctx = {"all": ctx, "half": ctx[:len(ctx) // 2], "one": ctx[:1],
           "none": []}[key[1]]
    assert (arith.decode_flops(QWEN, ctx), arith.decode_bytes(QWEN, ctx),
            arith.attention_kernel_bytes(QWEN, ctx)) == TICKS[key]


@pytest.mark.parametrize("prompt", list(PREFILL))
def test_prefill(prompt):
    assert arith.prefill_flops(QWEN, prompt) == PREFILL[prompt]


def _leaves(node, prefix=""):
    for k in sorted(node):
        if isinstance(node[k], dict):
            yield from _leaves(node[k], prefix + k + "/")
        else:
            yield prefix + k, node[k]


def test_tiny_weights_bitwise():
    a = spec.arch(tiny_cell("qwen3_longctx_decode").config)
    digest = hashlib.sha256()
    for path, leaf in _leaves(weights.make(a, SEED, "cpu")):
        digest.update(path.encode())
        digest.update(str(tuple(leaf.shape)).encode())
        digest.update(str(leaf.dtype).encode())
        digest.update(leaf.contiguous().view(torch.uint8).numpy().tobytes())
    assert digest.hexdigest() == TINY_TREE


def test_tiny_longctx_gap():
    out = harness.run_cell(tiny_cell("qwen3_longctx_decode", 0.07), SEED, 0.0,
                           False, "cpu", time.perf_counter())
    assert out.readings["logit_gap"] == TINY_LONGCTX_GAP
