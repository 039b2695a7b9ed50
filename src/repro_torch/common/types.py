"""Model configuration dataclasses (the port's own copy).

Frozen dataclasses, so configs are hashable.  Field names, defaults and
the segment split match the JAX package's configuration types, which is
what lets a test build one config and hand it to both packages.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class AttnConfig:
    kind: str = "gqa"  # "gqa" | "mla"
    n_heads: int = 8
    n_kv_heads: int = 8
    head_dim: int = 128
    rope_theta: float = 10_000.0
    # sliding-window attention (None/0 => full attention)
    window: int = 0
    qk_norm: bool = False
    # M-RoPE (qwen2-vl): section split of the rotary half-dim
    mrope_sections: Optional[Tuple[int, ...]] = None
    # MLA (deepseek-v2)
    kv_lora_rank: int = 512
    q_lora_rank: int = 0  # 0 => full-rank q projection
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    # sinusoidal absolute positions instead of RoPE (whisper)
    use_rope: bool = True

    @property
    def q_dim(self) -> int:
        if self.kind == "mla":
            return self.n_heads * (self.qk_nope_dim + self.qk_rope_dim)
        return self.n_heads * self.head_dim

    @property
    def kv_groups(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)


@dataclass(frozen=True)
class FFNConfig:
    d_ff: int = 0
    mlp_type: str = "swiglu"  # "swiglu" | "geglu" | "gelu"
    # MoE (only read when a LayerSpec says ffn="moe")
    n_experts: int = 0
    top_k: int = 0
    n_shared: int = 0
    moe_d_ff: int = 0  # expert hidden size (defaults to d_ff)
    dense_residual_ff: int = 0  # arctic-style always-on dense FFN in parallel
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    @property
    def expert_ff(self) -> int:
        return self.moe_d_ff or self.d_ff


@dataclass(frozen=True)
class SSMConfig:
    # mamba
    d_state: int = 16
    expand: int = 2
    dt_rank: int = 0  # 0 => d_model // 16
    conv_width: int = 4
    # rwkv6
    rwkv_head_dim: int = 64
    rwkv_lora_decay: int = 64
    rwkv_lora_mix: int = 32


@dataclass(frozen=True)
class LayerSpec:
    """What one transformer block is made of."""

    mixer: str  # "attn" | "attn_local" | "mamba" | "rwkv"
    ffn: str = "dense"  # "dense" | "moe" | "rwkv_cmix"


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | vlm | audio | cnn
    n_layers: int
    d_model: int
    vocab_size: int
    attn: AttnConfig = AttnConfig()
    ffn: FFNConfig = FFNConfig()
    ssm: SSMConfig = SSMConfig()
    # Repeating per-layer pattern; tiled to cover n_layers (remainder allowed).
    pattern: Tuple[LayerSpec, ...] = (LayerSpec("attn", "dense"),)
    # leading dense layers before the pattern starts (deepseek-v2 style)
    first_dense_layers: int = 0
    # rope theta for "attn_local" layers (gemma3 uses 10k local / 1M global)
    local_rope_theta: float = 10_000.0
    local_window: int = 0
    tie_embeddings: bool = False
    # encoder-decoder (whisper): n_layers is the decoder depth
    enc_dec: bool = False
    n_enc_layers: int = 0
    enc_max_frames: int = 1500
    # "tokens" | "embeds" (VLM/audio stub frontends feed embeddings directly)
    input_mode: str = "tokens"
    max_seq: int = 8192
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    # embedding scale (gemma multiplies by sqrt(d_model))
    scale_embeddings: bool = False
    logit_softcap: float = 0.0

    def layer_specs(self) -> Tuple[LayerSpec, ...]:
        lead = (LayerSpec(self.pattern[0].mixer, "dense"),) \
            * self.first_dense_layers
        n = self.n_layers - self.first_dense_layers
        reps = -(-n // len(self.pattern))  # ceil
        return lead + (self.pattern * reps)[:n]

    def segments(self) -> Tuple[Tuple[int, Tuple[LayerSpec, ...]], ...]:
        """Split layers into (count, period_specs) segments.

        n_layers = [first_dense] + count * len(pattern) + remainder; the
        remainder becomes a trailing count=1 segment so the apply path is
        uniform.
        """
        segs = []
        if self.first_dense_layers:
            segs.append((self.first_dense_layers,
                         (LayerSpec(self.pattern[0].mixer, "dense"),)))
        p = len(self.pattern)
        full, rem = divmod(self.n_layers - self.first_dense_layers, p)
        if full:
            segs.append((full, self.pattern))
        if rem:
            segs.append((1, self.pattern[:rem]))
        return tuple(segs)

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ECConfig:
    """The paper's hyper-parameters (Section 4/5)."""

    tau: int = 40  # local SGD steps between aggregations
    lam: float = 0.5  # initial combination coefficient (Eqn 9)
    p_steps: int = 20  # compression steps (paper: tau/2); lambda anneals to 0
    relabel_fraction: float = 0.7  # paper relabels 70% of D_k
    # pseudo-label accumulator: "dense" (exact) | "topk" (merge-prune)
    label_mode: str = "dense"
    top_m: int = 64  # accumulator width in topk mode
    aggregator: str = "ec"  # "ec" | "ma" | "sync" (baselines)
    protocol: str = "ring"  # "ring" | "allgather"
    # average probabilities (paper Eqn 6) or logits
    average_probs: bool = True
    # straggler policy: members whose heartbeat lags get dropped this round
    straggler_drop_max: int = 0
