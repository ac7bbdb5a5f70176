"""The frozen yardstick against numbers worked out by hand at the
configuration's published widths, and against the port's own arithmetic it
was copied from."""
import pytest

from pulbench import arith, spec

QWEN = spec.arch(spec.config("qwen3-1.7b"))


def test_kv_bytes_a_token():
    # 28 layers x (k, v) x 8 kv heads x 128 x 2 B
    assert QWEN.kv_row_bytes == 114_688


def test_qwen3_weight_bytes():
    # bf16: 28 x (2048 x 32 x 128 + 16 x 128 x 2048 + 3 x 2048 x 6144)
    # + 151,936 x 2048; fp32: 28 x (2 x 2048 + 2 x 128) + 2048 norm scales
    bf16 = 28 * (2048 * 32 * 128 + 16 * 128 * 2048 + 3 * 2048 * 6144) \
        + 151_936 * 2048
    assert bf16 == 1_720_451_072
    f32 = 28 * (2 * 2048 + 2 * 128) + 2048
    assert arith.decode_bytes(QWEN, []) == 2 * bf16 + 4 * f32 == 3_441_397_760


@pytest.mark.parametrize("a", [QWEN], ids=["qwen3"])
def test_each_cached_token_adds_its_row(a):
    base = arith.decode_bytes(a, [])
    assert arith.decode_bytes(a, [1000]) - base == pytest.approx(
        a.kv_row_bytes * 1001 + a.d * 2 * (not a.tied))
    one = arith.attention_kernel_bytes(a, [1000])
    two = arith.attention_kernel_bytes(a, [1000, 1000])
    assert two == 2 * one
    assert arith.attention_kernel_bytes(a, [2000]) - one == pytest.approx(
        1000 * a.kv_row_bytes / a.layers)


def test_qwen3_decode_flops():
    # 2 x 1,720,451,072 active parameters, and 28 layers x 16 heads x
    # (q.k + p.v) x 128 over 11 keys
    assert arith.decode_flops(QWEN, [10]) == (
        2 * 1_720_451_072 + 28 * 4 * 16 * 11 * 128)


def test_qwen3_long_context_tick():
    # the cell's 48 sessions at their prompts: 41.05 GB of KV a tick beside
    # the 3.44 GB of weights, and one layer's K1 launch a 28th of the KV
    from pulbench import traffic
    mix = spec.traffic("longctx_decode")
    ctx = traffic.quantile_sizes(mix["prompt"], mix["sessions"]).tolist()
    assert sum(ctx) == 357_911
    kv = 114_688 * (357_911 + 48)
    assert arith.decode_bytes(QWEN, ctx) == 3_441_397_760 + kv
    assert 28 * arith.attention_kernel_bytes(QWEN, ctx) == pytest.approx(
        114_688 * 357_911 + 28 * 48 * (2 * 16 * 128 * 2 + 2 * 4096), rel=0)


@pytest.mark.parametrize("name", ["qwen3-1.7b"])
def test_active_params_as_the_ports(name):
    from repro_torch.benchmarks.flops import active_params
    from repro_torch.configs.base import ModelConfig
    cfg = spec.config(name)
    assert arith.active_params(spec.arch(cfg)) == active_params(
        ModelConfig(**spec.port_config(cfg)))


def test_peaks():
    p = arith.peaks("NVIDIA H100 80GB HBM3")
    assert p["bf16_flops"] == 989e12 and p["hbm_bytes_per_s"] == 3.35e12
    assert arith.peaks("some other card") is None
