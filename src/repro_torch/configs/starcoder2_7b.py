"""starcoder2-7b [arXiv:2402.19173] — dense GQA, RoPE, gelu MLP."""
from repro_torch.common.types import (AttnConfig, FFNConfig, LayerSpec,
                                      ModelConfig)

CONFIG = ModelConfig(
    name="starcoder2-7b", family="dense",
    n_layers=32, d_model=4608, vocab_size=49152,
    attn=AttnConfig(kind="gqa", n_heads=36, n_kv_heads=4, head_dim=128,
                    rope_theta=1_000_000.0),
    ffn=FFNConfig(d_ff=18432, mlp_type="gelu"),
    pattern=(LayerSpec("attn", "dense"),),
    max_seq=131072,
)

SIZE_CLASS = "small"
SKIP_SHAPES = {"long_500k": "pure full-attention arch"}


def reduced() -> ModelConfig:
    return CONFIG.with_(
        n_layers=3, d_model=144, vocab_size=512,
        attn=CONFIG.attn.__class__(kind="gqa", n_heads=6, n_kv_heads=2,
                                   head_dim=24, rope_theta=1e6),
        ffn=CONFIG.ffn.__class__(d_ff=288, mlp_type="gelu"),
        max_seq=256)
