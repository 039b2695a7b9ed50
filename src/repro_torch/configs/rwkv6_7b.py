"""rwkv6-7b (Finch) [arXiv:2404.05892] — attention-free, data-dependent decay.

Every layer is an rwkv6 time-mix (the wkv recurrence) followed by the
rwkv channel-mix; nothing pages under paged serving, and each slot's
decode state is O(1) in sequence length (token-shift tails and a
(H, dh, dh) wkv state per layer).
"""
from repro_torch.common.types import (AttnConfig, FFNConfig, LayerSpec,
                                      ModelConfig, SSMConfig)

CONFIG = ModelConfig(
    name="rwkv6-7b", family="ssm",
    n_layers=32, d_model=4096, vocab_size=65536,
    attn=AttnConfig(n_heads=64, n_kv_heads=64, head_dim=64),  # unused
    ffn=FFNConfig(d_ff=14336),
    ssm=SSMConfig(rwkv_head_dim=64, rwkv_lora_decay=64, rwkv_lora_mix=32),
    pattern=(LayerSpec("rwkv", "rwkv_cmix"),),
    max_seq=1048576,
)

SIZE_CLASS = "small"
SKIP_SHAPES = {}


def reduced() -> ModelConfig:
    return CONFIG.with_(
        n_layers=3, d_model=128, vocab_size=512,
        ffn=CONFIG.ffn.__class__(d_ff=256),
        ssm=CONFIG.ssm.__class__(rwkv_head_dim=32, rwkv_lora_decay=16,
                                 rwkv_lora_mix=8),
        max_seq=256)
