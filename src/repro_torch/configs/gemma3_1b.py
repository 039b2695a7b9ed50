"""gemma3-1b [hf:google/gemma-3-1b-pt] — 5:1 local:global SWA, 262k vocab.

head_dim=256 is explicit (not d_model/n_heads).  Local layers use a 512-token
sliding window with rope theta 10k; the global layer uses theta 1M.
"""
from repro_torch.common.types import (AttnConfig, FFNConfig, LayerSpec,
                                      ModelConfig)

CONFIG = ModelConfig(
    name="gemma3-1b", family="dense",
    n_layers=26, d_model=1152, vocab_size=262144,
    attn=AttnConfig(kind="gqa", n_heads=4, n_kv_heads=1, head_dim=256,
                    rope_theta=1_000_000.0, qk_norm=True),
    ffn=FFNConfig(d_ff=6912, mlp_type="geglu"),
    pattern=(LayerSpec("attn_local", "dense"),) * 5
            + (LayerSpec("attn", "dense"),),
    local_rope_theta=10_000.0, local_window=512,
    tie_embeddings=True, scale_embeddings=True,
    max_seq=524288,
)


def reduced() -> ModelConfig:
    return CONFIG.with_(
        n_layers=7, d_model=128, vocab_size=512,
        attn=AttnConfig(kind="gqa", n_heads=4, n_kv_heads=1, head_dim=32,
                        rope_theta=1e6, qk_norm=True),
        ffn=FFNConfig(d_ff=256, mlp_type="geglu"),
        local_window=16, max_seq=256)
