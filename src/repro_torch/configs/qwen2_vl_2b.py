"""qwen2-vl-2b [arXiv:2409.12191] — M-RoPE, dynamic-resolution VLM backbone.

The vision frontend is a stub: callers may feed precomputed patch
embeddings through `embeds`; the LM shapes use ordinary tokens.  M-RoPE
sections (16, 24, 24) split the 64-dim rotary half-space over (temporal,
height, width) position streams.
"""
from repro_torch.common.types import (AttnConfig, FFNConfig, LayerSpec,
                                      ModelConfig)

CONFIG = ModelConfig(
    name="qwen2-vl-2b", family="vlm",
    n_layers=28, d_model=1536, vocab_size=151936,
    attn=AttnConfig(kind="gqa", n_heads=12, n_kv_heads=2, head_dim=128,
                    rope_theta=1_000_000.0, mrope_sections=(16, 24, 24)),
    ffn=FFNConfig(d_ff=8960, mlp_type="swiglu"),
    pattern=(LayerSpec("attn", "dense"),),
    tie_embeddings=True,
    max_seq=131072,
)

SIZE_CLASS = "small"
SKIP_SHAPES = {"long_500k": "pure full-attention arch"}


def reduced() -> ModelConfig:
    return CONFIG.with_(
        n_layers=3, d_model=128, vocab_size=512,
        attn=AttnConfig(kind="gqa", n_heads=4, n_kv_heads=2, head_dim=32,
                        rope_theta=1e6, mrope_sections=(4, 6, 6)),
        ffn=FFNConfig(d_ff=256, mlp_type="swiglu"),
        max_seq=256)
