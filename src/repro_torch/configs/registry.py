"""Architecture registry: --arch <id> -> ModelConfig, for the archs ported so far."""
from __future__ import annotations

import importlib

from repro_torch.common.types import ModelConfig

_MODULES = {
    "gemma3-1b": "repro_torch.configs.gemma3_1b",
    "deepseek-7b": "repro_torch.configs.deepseek_7b",
    "paper_nin": "repro_torch.configs.paper_nin",
    "rwkv6-7b": "repro_torch.configs.rwkv6_7b",
    "jamba-v0.1-52b": "repro_torch.configs.jamba_52b",
}

# archs the JAX package serves that this package does not run yet
NOT_PORTED = ("llama3-405b", "starcoder2-7b", "deepseek-v2-236b",
              "arctic-480b", "qwen2-vl-2b", "whisper-tiny")

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str, reduced: bool = False) -> ModelConfig:
    if arch in NOT_PORTED:
        raise NotImplementedError(
            f"arch {arch!r} is not ported to repro_torch yet; ported: "
            f"{sorted(_MODULES)}")
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    m = importlib.import_module(_MODULES[arch])
    return m.reduced() if reduced else m.CONFIG
