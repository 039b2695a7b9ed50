"""whisper-tiny [arXiv:2212.04356] — enc-dec audio backbone, conv stub.

4-layer encoder over 1500 precomputed frame embeddings (the mel+conv
frontend is a stub: callers feed frame embeddings as `enc_embeds`) and a
4-layer decoder with cross-attention.  max_seq=32k stretches the
448-token trained range for decode shapes only.  Sinusoidal positions,
no RoPE.
"""
from repro_torch.common.types import (AttnConfig, FFNConfig, LayerSpec,
                                      ModelConfig)

CONFIG = ModelConfig(
    name="whisper-tiny", family="audio",
    n_layers=4, d_model=384, vocab_size=51865,
    attn=AttnConfig(kind="gqa", n_heads=6, n_kv_heads=6, head_dim=64,
                    use_rope=False),
    ffn=FFNConfig(d_ff=1536, mlp_type="gelu"),
    pattern=(LayerSpec("attn", "dense"),),
    enc_dec=True, n_enc_layers=4, enc_max_frames=1500,
    max_seq=32768,
)

SIZE_CLASS = "small"
SKIP_SHAPES = {"long_500k": "enc-dec; audio context is 1500 frames by "
                            "construction (pure full attention)"}


def reduced() -> ModelConfig:
    return CONFIG.with_(
        n_layers=2, d_model=64, vocab_size=512,
        attn=AttnConfig(kind="gqa", n_heads=2, n_kv_heads=2, head_dim=32,
                        use_rope=False),
        ffn=FFNConfig(d_ff=128, mlp_type="gelu"),
        enc_dec=True, n_enc_layers=2, enc_max_frames=64,
        max_seq=128)
