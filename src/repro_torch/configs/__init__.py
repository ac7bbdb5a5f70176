"""Config registry of the port: ``get_config(arch_id)``.

Only the architectures the port serves so far are registered (qwen3-1.7b,
deepseek-v2-236b, qwen2.5-32b, gemma2-27b, gemma3-12b, grok-1-314b,
internvl2-2b, musicgen-large); the reference zoo's recurrent archs raise
``NotImplementedError`` (ROADMAP, queue of the port).
"""
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.configs.deepseek_v2_236b import CONFIG as _deepseek_v2_236b
from repro_torch.configs.gemma2_27b import CONFIG as _gemma2_27b
from repro_torch.configs.gemma3_12b import CONFIG as _gemma3_12b
from repro_torch.configs.grok_1_314b import CONFIG as _grok_1_314b
from repro_torch.configs.internvl2_2b import CONFIG as _internvl2_2b
from repro_torch.configs.musicgen_large import CONFIG as _musicgen_large
from repro_torch.configs.qwen2_5_32b import CONFIG as _qwen2_5_32b
from repro_torch.configs.qwen3_1_7b import CONFIG as _qwen3_1_7b

CONFIGS = {c.name: c for c in (_qwen3_1_7b, _deepseek_v2_236b, _qwen2_5_32b,
                               _gemma2_27b, _gemma3_12b, _grok_1_314b,
                               _internvl2_2b, _musicgen_large)}

# the reference zoo's other arch ids, still in the port's queue
PENDING_ARCHS = ("rwkv6-7b", "zamba2-7b")

ARCH_IDS = tuple(CONFIGS)


def get_config(arch: str) -> ModelConfig:
    if arch in CONFIGS:
        return CONFIGS[arch]
    if arch in PENDING_ARCHS:
        raise NotImplementedError(
            f"{arch!r} is not ported to PyTorch yet; see ROADMAP.md, "
            "'Port: modules still to port'")
    raise KeyError(f"unknown arch {arch!r}; known: {sorted(CONFIGS)}")


__all__ = ["CONFIGS", "ARCH_IDS", "PENDING_ARCHS", "get_config",
           "ModelConfig", "InputShape"]
