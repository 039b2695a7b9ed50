"""Token sampling on the fused ensemble distribution (log space).

`sample_slots` gives every batch row its own temperature, top-k and seed.
Greedy rows (temperature <= 0) take the argmax on the device with no
host round trip.  A stochastic row draws by Gumbel-max from a
torch.Generator (Philox on the card) seeded from the request seed and
the row's emission index, so a request regenerates token-identically
for the same seed.  The numbers differ from the JAX package's
jax.random draws; only their distribution is the same.

The MIN_*/MAX_* limits are the named request-validation bounds:
engine.validate_request rejects out-of-range values with errors that
quote them.
"""
from __future__ import annotations

import numpy as np
import torch

NEG_INF = -1e30

# door-time limits for per-request sampling params (validate_request)
MIN_TEMPERATURE = 0.0
MAX_TEMPERATURE = 100.0
MIN_SEED = 0
MAX_SEED = 2 ** 31 - 1  # top_k's upper bound is the model's vocab_size


def top_k_mask_rows(log_probs: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Per-row top-k: log_probs (B, V), k (B,) int (<= 0 keeps every
    entry).  Entries equal to the k-th value survive."""
    V = log_probs.shape[-1]
    srt = torch.sort(log_probs, dim=-1, descending=True).values
    kk = torch.where(k > 0, k, V).clamp(1, V).long()
    thr = srt.gather(1, kk[:, None] - 1)
    return torch.where(log_probs < thr, NEG_INF, log_probs)


_M64 = (1 << 64) - 1


def draw_seed(seed: int, n_gen: int) -> int:
    """Generator seed of a request's emission n_gen: splitmix64 of the
    (seed, n_gen) pair, so every bit depends on both (the CPU generator
    reads only the low 32 bits of its seed)."""
    z = (((int(seed) << 32) | (int(n_gen) & 0xFFFFFFFF))
         + 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return (z ^ (z >> 31)) >> 1  # 63 bits: a valid manual_seed everywhere


def sample_slots(log_probs: torch.Tensor, temperature: np.ndarray,
                 top_k: np.ndarray, seeds: np.ndarray,
                 n_gen: torch.Tensor) -> torch.Tensor:
    """log_probs (B, V) fused log-probs on the device; temperature,
    top_k, seeds (B,) host arrays; n_gen (B,) emission index per row.
    -> (B,) int64 token ids on log_probs' device.  n_gen is read on the
    host only when some row samples."""
    greedy = log_probs.argmax(dim=-1)
    rows = np.nonzero(np.asarray(temperature) > 0)[0]
    if rows.size == 0:
        return greedy
    dev = log_probs.device
    gen_idx = n_gen.tolist()
    out = greedy.clone()
    lp = top_k_mask_rows(log_probs[rows],
                         torch.as_tensor(np.asarray(top_k)[rows], device=dev))
    for j, b in enumerate(rows):
        g = torch.Generator(device=dev)
        g.manual_seed(draw_seed(seeds[b], gen_idx[b]))
        u = torch.rand(lp.shape[-1], generator=g, device=dev)
        gumbel = -torch.log(-torch.log(u))
        out[b] = (lp[j] / float(temperature[b]) + gumbel).argmax()
    return out
