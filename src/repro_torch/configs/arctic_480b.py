"""arctic-480b [hf:Snowflake/snowflake-arctic-base] — 128e top-2 + dense
residual.  Every layer runs a dense FFN in parallel with the MoE branch
(dense_residual_ff), Snowflake's dense-MoE hybrid."""
from repro_torch.common.types import (AttnConfig, FFNConfig, LayerSpec,
                                      ModelConfig)

CONFIG = ModelConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, vocab_size=32000,
    attn=AttnConfig(kind="gqa", n_heads=56, n_kv_heads=8, head_dim=128,
                    rope_theta=10_000.0),
    ffn=FFNConfig(d_ff=4864, mlp_type="swiglu", n_experts=128, top_k=2,
                  moe_d_ff=4864, dense_residual_ff=4864),
    pattern=(LayerSpec("attn", "moe"),),
    max_seq=131072,
)

SIZE_CLASS = "big"
SKIP_SHAPES = {"long_500k": "pure full-attention arch"}


def reduced() -> ModelConfig:
    return CONFIG.with_(
        n_layers=3, d_model=128, vocab_size=512,
        attn=CONFIG.attn.__class__(kind="gqa", n_heads=4, n_kv_heads=2,
                                   head_dim=32, rope_theta=1e4),
        ffn=CONFIG.ffn.__class__(d_ff=128, mlp_type="swiglu", n_experts=8,
                                 top_k=2, moe_d_ff=128,
                                 dense_residual_ff=128),
        max_seq=256)
