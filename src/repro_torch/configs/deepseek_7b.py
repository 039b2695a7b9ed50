"""deepseek-7b [arXiv:2401.02954] — llama-arch dense MHA (kv == heads).

Every layer is full attention (no window), so under paged serving every
layer pages.  Untied LM head, swiglu MLP.
"""
from repro_torch.common.types import (AttnConfig, FFNConfig, LayerSpec,
                                      ModelConfig)

CONFIG = ModelConfig(
    name="deepseek-7b", family="dense",
    n_layers=30, d_model=4096, vocab_size=102400,
    attn=AttnConfig(kind="gqa", n_heads=32, n_kv_heads=32, head_dim=128,
                    rope_theta=10_000.0),
    ffn=FFNConfig(d_ff=11008, mlp_type="swiglu"),
    pattern=(LayerSpec("attn", "dense"),),
    max_seq=131072,
)


def reduced() -> ModelConfig:
    return CONFIG.with_(
        n_layers=3, d_model=128, vocab_size=512,
        attn=AttnConfig(kind="gqa", n_heads=4, n_kv_heads=4, head_dim=32,
                        rope_theta=1e4),
        ffn=FFNConfig(d_ff=256, mlp_type="swiglu"),
        max_seq=256)
