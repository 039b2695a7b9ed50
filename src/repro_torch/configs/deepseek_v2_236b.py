"""deepseek-v2-236b [arXiv:2405.04434] — MLA (kv_lora=512), MoE 160e top-6.

2 shared + 160 routed experts (top-6), expert d_ff=1536 per the assignment;
the first layer is dense with d_ff=12288 as published.  MLA caches the 512-d
latent + 64-d rope key instead of per-head KV — 36x smaller decode cache.
"""
from repro_torch.common.types import (AttnConfig, FFNConfig, LayerSpec,
                                      ModelConfig)

CONFIG = ModelConfig(
    name="deepseek-v2-236b", family="moe",
    n_layers=60, d_model=5120, vocab_size=102400,
    attn=AttnConfig(kind="mla", n_heads=128, n_kv_heads=128,
                    kv_lora_rank=512, q_lora_rank=1536,
                    qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
                    rope_theta=10_000.0),
    ffn=FFNConfig(d_ff=12288, mlp_type="swiglu", n_experts=160, top_k=6,
                  n_shared=2, moe_d_ff=1536),
    pattern=(LayerSpec("attn", "moe"),),
    first_dense_layers=1,
    max_seq=131072,
)

SIZE_CLASS = "big"
SKIP_SHAPES = {"long_500k": "pure full-attention arch"}


def reduced() -> ModelConfig:
    return CONFIG.with_(
        n_layers=3, d_model=128, vocab_size=512,
        attn=CONFIG.attn.__class__(kind="mla", n_heads=4, n_kv_heads=4,
                                   kv_lora_rank=32, q_lora_rank=48,
                                   qk_nope_dim=32, qk_rope_dim=16,
                                   v_head_dim=32, rope_theta=1e4),
        ffn=CONFIG.ffn.__class__(d_ff=384, mlp_type="swiglu", n_experts=8,
                                 top_k=2, n_shared=1, moe_d_ff=64),
        max_seq=256)
