"""Architecture registry: --arch <id> -> ModelConfig, every arch of the
JAX package's registry, and the dry-run's parallelism policy (the JAX
registry's):
  - "small" archs (fit one TP group): EC ensemble axis = "data"
    (K = |data|), params replicated per member + TP over "model".
  - "big" archs: FSDP over "data" inside each member, ensemble axis =
    "pod" (K = |pod| multi-pod; K = 1 single-pod).
  - serving (prefill/decode cells): one model, batch over ("pod","data"),
    TP over "model", FSDP over "data" for big archs.
"""
from __future__ import annotations

import importlib
from typing import Tuple

from repro_torch.common.types import (ModelConfig, ParallelConfig,
                                      ShapeConfig)

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

# the JAX package's registry.ARCH_IDS, in its order: every arch but the
# paper's NiN (a CNN, which has no dry-run cell)
LM_ARCH_IDS = ("llama3-405b", "gemma3-1b", "starcoder2-7b", "deepseek-7b",
               "jamba-v0.1-52b", "rwkv6-7b", "deepseek-v2-236b",
               "arctic-480b", "qwen2-vl-2b", "whisper-tiny")


def get_module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[arch])


def get_config(arch: str, reduced: bool = False) -> ModelConfig:
    m = get_module(arch)
    return m.reduced() if reduced else m.CONFIG


def size_class(arch: str) -> str:
    return get_module(arch).SIZE_CLASS


def skip_reason(arch: str, shape_name: str) -> str | None:
    return get_module(arch).SKIP_SHAPES.get(shape_name)


def parallel_policy(arch: str, shape: ShapeConfig,
                    multi_pod: bool) -> ParallelConfig:
    big = size_class(arch) == "big"
    if shape.kind == "train":
        if big:
            # members don't fit one TP group: FSDP over "data" inside the
            # member, ensemble across pods (K=1 single-pod)
            return ParallelConfig(
                ensemble_axis="pod" if multi_pod else "",
                ensemble_size=2 if multi_pod else 1,
                fsdp_axis="data", model_axis="model",
                batch_axes=("data",),  # FSDP = DP over the param-shard axis
                seq_axis="model",      # SP: layer-boundary residuals
                remat=True)
        # member = one TP group; K = |data| members; member batch gets DP
        # over "pod" when present
        return ParallelConfig(ensemble_axis="data", ensemble_size=0,
                              fsdp_axis="", model_axis="model",
                              batch_axes=("pod",), remat=True)
    # serving: single model
    return ParallelConfig(ensemble_axis="", ensemble_size=1,
                          fsdp_axis="data" if big else "",
                          model_axis="model",
                          batch_axes=("pod", "data"), remat=False)


def all_cells() -> Tuple[Tuple[str, str], ...]:
    """All (arch, shape) dry-run cells, documented skips included: the
    JAX registry's 10 archs x 4 shapes, in its order."""
    from repro_torch.common.types import SHAPES
    return tuple((arch, shape) for arch in LM_ARCH_IDS for shape in SHAPES)


def runnable_cells() -> Tuple[Tuple[str, str], ...]:
    return tuple((a, s) for a, s in all_cells()
                 if skip_reason(a, s) is None)
