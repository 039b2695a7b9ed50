"""jamba-v0.1-52b [arXiv:2403.19887] — Mamba+attn 1:7 hybrid, MoE 16e top-2.

Period of 8 layers with one attention layer (slot 3) and MoE on every odd
slot (e_step=2), matching the published interleave.  32 layers = 4
periods.  Under paged serving the attention layer pages (no window) and
the Mamba layers carry O(1) recurrent state per slot (conv tail and ssm
state).  The 32-layer model's bf16 weights (~103 GB a member) do not fit
one 80 GB card; one period (8 layers, ~26.6 GB a member) does.
"""
from repro_torch.common.types import (AttnConfig, FFNConfig, LayerSpec,
                                      ModelConfig, SSMConfig)

_PERIOD = (
    LayerSpec("mamba", "dense"), LayerSpec("mamba", "moe"),
    LayerSpec("mamba", "dense"), LayerSpec("attn", "moe"),
    LayerSpec("mamba", "dense"), LayerSpec("mamba", "moe"),
    LayerSpec("mamba", "dense"), LayerSpec("mamba", "moe"),
)

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, vocab_size=65536,
    attn=AttnConfig(kind="gqa", n_heads=32, n_kv_heads=8, head_dim=128,
                    use_rope=False),  # jamba attends without rope
    ffn=FFNConfig(d_ff=14336, mlp_type="swiglu", n_experts=16, top_k=2,
                  moe_d_ff=14336),
    ssm=SSMConfig(d_state=16, expand=2, conv_width=4),
    pattern=_PERIOD,
    max_seq=262144,
)


def reduced() -> ModelConfig:
    return CONFIG.with_(
        n_layers=8, d_model=128, vocab_size=512,
        attn=CONFIG.attn.__class__(kind="gqa", n_heads=4, n_kv_heads=2,
                                   head_dim=32, use_rope=False),
        ffn=CONFIG.ffn.__class__(d_ff=256, mlp_type="swiglu", n_experts=4,
                                 top_k=2, moe_d_ff=256),
        ssm=CONFIG.ssm.__class__(d_state=8, expand=2, conv_width=4),
        max_seq=256)
