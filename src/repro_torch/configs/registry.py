"""Architecture registry: --arch <id> -> ModelConfig, every arch of the
JAX package's registry."""
from __future__ import annotations

import importlib

from repro_torch.common.types import ModelConfig

_MODULES = {
    "gemma3-1b": "repro_torch.configs.gemma3_1b",
    "deepseek-7b": "repro_torch.configs.deepseek_7b",
    "paper_nin": "repro_torch.configs.paper_nin",
    "rwkv6-7b": "repro_torch.configs.rwkv6_7b",
    "jamba-v0.1-52b": "repro_torch.configs.jamba_52b",
    "deepseek-v2-236b": "repro_torch.configs.deepseek_v2_236b",
    "starcoder2-7b": "repro_torch.configs.starcoder2_7b",
    "llama3-405b": "repro_torch.configs.llama3_405b",
    "arctic-480b": "repro_torch.configs.arctic_480b",
    "qwen2-vl-2b": "repro_torch.configs.qwen2_vl_2b",
    "whisper-tiny": "repro_torch.configs.whisper_tiny",
}

# archs the JAX package serves that this package does not run: none
NOT_PORTED: tuple = ()

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str, reduced: bool = False) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    m = importlib.import_module(_MODULES[arch])
    return m.reduced() if reduced else m.CONFIG
