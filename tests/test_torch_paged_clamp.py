"""Reads through an unallocated page-table entry, port against JAX.

A decode row whose page table holds the sentinel (unallocated) at a
logical page below the row's length reads a clamped page, masked by
position only past the length.  The JAX package keeps one pool per
member and layer and clamps to that pool's last page; the port folds
members and layers into one pool and must clamp to the same page, the
last one of the member's own layer.  The pool is filled with random
values so that every page differs.  Reduced gemma3-1b at f32, K=2,
all layers paged; logits within atol=rtol=1e-4 as in
tests/test_torch_model.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import registry as jreg
from repro.models import transformer as jtf
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import registry as treg
from repro_torch.models import transformer as ttf

K, B, PAGE, MAX_SEQ = 2, 2, 4, 16


def test_sentinel_below_length_reads_the_layers_own_last_page():
    jcfg = jreg.get_config("gemma3-1b", reduced=True).with_(dtype="float32")
    tcfg = treg.get_config("gemma3-1b", reduced=True).with_(dtype="float32")
    assert tcfg.local_window >= MAX_SEQ  # every layer pages
    jp = jax.vmap(lambda k: jtf.init(k, jcfg))(
        jax.random.split(jax.random.PRNGKey(0), K))
    tp = params_from_numpy(jax.device_get(jp), "cpu")
    P = MAX_SEQ // PAGE
    n_pages = B * P
    kw = dict(page_size=PAGE, n_pages=n_pages)
    jc = jax.vmap(lambda _: jtf.init_slot_cache(jcfg, B, MAX_SEQ, **kw))(
        jnp.arange(K))
    tc = ttf.init_slot_cache(tcfg, B, MAX_SEQ, members=K, device="cpu",
                             **kw)
    rng = np.random.default_rng(0)
    for jseg, tseg in zip(jc["segments"], tc["segments"]):
        for name, tslot in tseg.items():
            for leaf, t in tslot.items():
                assert tuple(jseg[name][leaf].shape) == tuple(t.shape)
                a = rng.standard_normal(t.shape).astype(np.float32)
                jseg[name][leaf] = jnp.asarray(a)
                t.copy_(torch.from_numpy(a))
    pos = np.array([9, 13], np.int32)       # pages 0-2 and 0-3 are live
    table = np.array([[5, n_pages, 0, 7],   # row 0: page 1 unallocated
                      [1, 2, 3, 4]], np.int32)
    jc["idx"] = jnp.broadcast_to(pos, (K, B))
    tc["idx"] = torch.from_numpy(pos).expand(K, B).contiguous()
    jc["page_table"] = jnp.broadcast_to(table, (K, B, P))
    tc["page_table"] = torch.from_numpy(table).expand(K, B, P).contiguous()
    tok = rng.integers(0, jcfg.vocab_size, (B, 1)).astype(np.int32)
    want, _ = jax.vmap(lambda p, c: jtf.decode_step_paged(p, jcfg, c, tok))(
        jp, jc)
    got, _ = ttf.decode_step_paged(tp, tcfg, tc, torch.from_numpy(tok))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
