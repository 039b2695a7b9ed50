"""llama3-405b [arXiv:2407.21783] — dense GQA, 128k vocab."""
from repro_torch.common.types import (AttnConfig, FFNConfig, LayerSpec,
                                      ModelConfig)

CONFIG = ModelConfig(
    name="llama3-405b", family="dense",
    n_layers=126, d_model=16384, vocab_size=128256,
    attn=AttnConfig(kind="gqa", n_heads=128, n_kv_heads=8, head_dim=128,
                    rope_theta=500_000.0),
    ffn=FFNConfig(d_ff=53248, mlp_type="swiglu"),
    pattern=(LayerSpec("attn", "dense"),),
    max_seq=131072,
)

SIZE_CLASS = "big"
# pure full attention: 500k-token decode cache is O(seq) per layer at 126
# layers: sub-quadratic-attention shapes are out of scope.
SKIP_SHAPES = {"long_500k": "pure full-attention arch"}


def reduced() -> ModelConfig:
    return CONFIG.with_(
        n_layers=4, d_model=256, vocab_size=512,
        attn=CONFIG.attn.__class__(kind="gqa", n_heads=8, n_kv_heads=2,
                                   head_dim=32, rope_theta=500_000.0),
        ffn=CONFIG.ffn.__class__(d_ff=512, mlp_type="swiglu"),
        max_seq=256)
