"""Model facade: family dispatch between the transformer and the CNN.

EC-DNN's core depends only on this: it treats any model as "params ->
per-example categorical distribution".  Params are member-stacked.
"""
from __future__ import annotations

import torch

from repro_torch.common.device import DeviceLike
from repro_torch.common.types import ModelConfig


def init(cfg: ModelConfig, seed: int = 0, device: DeviceLike = None,
         members: int = 1) -> dict:
    """Member-stacked params, torch-seeded, on the card unless `device`
    says otherwise; device="meta" makes each leaf's shape and dtype and
    draws nothing (the JAX package's jax.eval_shape of init)."""
    if cfg.family == "cnn":
        from repro_torch.models import cnn
        # d_model doubles as the NiN width knob (192 = the paper's size)
        return cnn.nin_init(n_classes=cfg.vocab_size,
                            width_mult=cfg.d_model / 192.0, seed=seed,
                            device=device, members=members)
    from repro_torch.models import transformer
    return transformer.init(cfg, seed=seed, device=device, members=members)


def activation_floats(cfg: ModelConfig, params, inputs: dict) -> int:
    """f32 elements of the largest activation one input row (an image)
    makes in one member's forward, at the resolution of `inputs`: a
    CNN's widest layer output (cnn.peak_floats); 0 for the transformer,
    whose logits, which aggregation.chunk_rows bounds anyway, are the
    larger."""
    if cfg.family == "cnn":
        from repro_torch.models import cnn
        h, w = inputs["images"].shape[-3:-1]
        return cnn.peak_floats(params, h, w)
    return 0


def predict_logits(params, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """Logits over classes/vocab, (K, B, ..., V) — what EC-DNN ensembles
    (Eqn 6).  A CNN batch holds one image batch per member, (K, B, H, W,
    C); a token batch (B, T) is shared by all members."""
    if cfg.family == "cnn":
        from repro_torch.models import cnn
        return cnn.nin_apply(params, batch["images"])
    from repro_torch.models import transformer
    logits, _ = transformer.apply(params, cfg, batch["tokens"])
    return logits
