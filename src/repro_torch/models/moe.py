"""Mixture-of-Experts FFN with top-k routing and capacity-based dispatch,
over the member-stacked layout (jamba's MoE layers).

The JAX package's semantics, kept exactly: tokens are routed by a
softmax router in f32, take capacity slots in order of arrival (a
cumsum over the (token, k) assignments, token first), are gathered into
an (E, C, d) buffer, run through every expert's swiglu FFN, and are
combined back with their renormalized top-k weights.  Assignments past
an expert's capacity are dropped and add nothing.

Routing and capacity are per token pool, and every member routes its own
tokens: x is (K, G, S, d), G pools of S tokens for each of the K
members.  The pool is what one call of the JAX package's moe_apply sees
(all tokens of a forward, of a paged decode step, or one row's chunk of
a prefill); models/transformer.py picks it.

The per-expert FFN is one batched product over the E experts of each
member (torch.bmm), as the JAX package leaves it to XLA: a layer's
(K, E, d, ff) weight view is strided over the count axis of its
segment, so a single (K*E) batch would need a copy of the weights.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.common.types import FFNConfig
from repro_torch.models.layers import dense_init, mlp_apply, mlp_init, mm


def moe_init(gen, lead, d_model: int, f: FFNConfig, dtype) -> dict:
    E, ff = f.n_experts, f.expert_ff
    per_expert = (*lead, E)   # filled one (member, layer, expert) at a time
    p = {
        "router": dense_init(gen, lead, (d_model, E), torch.float32),
        "experts_gate": dense_init(gen, per_expert, (d_model, ff), dtype),
        "experts_up": dense_init(gen, per_expert, (d_model, ff), dtype),
        "experts_down": dense_init(gen, per_expert, (ff, d_model), dtype),
    }
    if f.n_shared:
        p["shared"] = mlp_init(gen, lead, d_model, f.n_shared * ff, "swiglu",
                               dtype)
    if f.dense_residual_ff:
        p["dense_res"] = mlp_init(gen, lead, d_model, f.dense_residual_ff,
                                  "swiglu", dtype)
    return p


def _route(router_w: torch.Tensor, x_f32: torch.Tensor, top_k: int):
    """x (K, G, T, d) f32 -> (weights (K, G, T, k), ids (K, G, T, k),
    aux (K, G))."""
    probs = torch.softmax(mm(x_f32, router_w), dim=-1)
    w, ids = torch.topk(probs, top_k, dim=-1)
    w = w / w.sum(-1, keepdim=True).clamp_min(1e-9)   # renormalize top-k
    # Switch-style load-balance loss: E * sum_e f_e * p_e, per pool
    E = router_w.shape[-1]
    T = ids.shape[2]
    counts = F.one_hot(ids.flatten(2), E).sum(2).float()   # (K, G, E)
    f_e = counts * (E / (T * top_k))
    aux = (f_e * probs.mean(2)).sum(-1) * E
    return w, ids, aux


def _experts(params: dict, xe: torch.Tensor) -> torch.Tensor:
    """xe (K, E, n, d) -> every member's experts' swiglu FFN, (K, E, n,
    d): one bmm over the E experts per member and weight."""
    out = torch.empty_like(xe)
    for k in range(xe.shape[0]):
        g = torch.bmm(xe[k], params["experts_gate"][k])
        u = torch.bmm(xe[k], params["experts_up"][k])
        torch.bmm(F.silu(g) * u, params["experts_down"][k], out=out[k])
    return out


def moe_apply(params: dict, x: torch.Tensor, f: FFNConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (K, G, T, d), G token pools of T tokens per member -> (out (K,
    G, T, d), aux (K, G) already scaled by router_aux_coef)."""
    K, G, T, d = x.shape
    E, k = f.n_experts, f.top_k
    # per-expert capacity; floor of min(T*k, 64) makes small token counts
    # (decode steps, unit tests) effectively dropless
    C = max(int(T * k * f.capacity_factor / E), min(T * k, 64))
    w, ids, aux = _route(params["router"], x.float(), k)

    # --- capacity-slot assignment: arrival rank, token first ------------
    flat_ids = ids.reshape(K, G, T * k)
    flat_w = w.reshape(K, G, T * k)
    onehot = F.one_hot(flat_ids, E)                        # (K, G, Tk, E)
    rank = torch.cumsum(onehot, 2) - onehot
    slot = rank.gather(3, flat_ids[..., None])[..., 0]
    dest = torch.where(slot < C, flat_ids * C + slot, E * C)  # E*C: trash

    # --- dispatch: slot -> source token (T, the zero row, where empty) --
    pools = torch.arange(K * G, device=x.device).reshape(K, G, 1)
    slot_to_tok = torch.full((K, G, E * C + 1), T * k, dtype=torch.long,
                             device=x.device)
    slot_to_tok.scatter_(2, dest, torch.arange(T * k, device=x.device)
                         .expand(K, G, T * k))
    tok_ids = slot_to_tok[..., :E * C] // k                # (K, G, E*C)
    x_plus = torch.cat([x, x.new_zeros(K, G, 1, d)], 2)
    disp = x_plus.reshape(-1, d).index_select(
        0, (tok_ids + pools * (T + 1)).reshape(-1))
    xe = disp.reshape(K, G, E, C, d).transpose(1, 2).reshape(K, E, G * C, d)

    # --- per-expert FFN, then combine ------------------------------------
    out_e = _experts(params, xe).reshape(K, E, G, C, d).transpose(1, 2)
    flat_out = torch.cat([out_e.reshape(K, G, E * C, d),
                          out_e.new_zeros(K, G, 1, d)], 2)
    tok_out = flat_out.reshape(-1, d).index_select(
        0, (dest + pools * (E * C + 1)).reshape(-1))
    tok_out = tok_out.reshape(K, G, T * k, d) * flat_w[..., None].to(x.dtype)
    y = tok_out.reshape(K, G, T, k, d).sum(3)

    if "shared" in params:
        y = y + mlp_apply(params["shared"], x, "swiglu")
    if "dense_res" in params:
        y = y + mlp_apply(params["dense_res"], x, "swiglu")
    return y, aux * f.router_aux_coef
