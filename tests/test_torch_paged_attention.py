"""The port's paged-attention decode against the JAX package's.

The plain PyTorch version (repro_torch.kernels.ref) is held against
repro.kernels.ref.paged_attention on the same numpy inputs, in every
option the kernel takes, and once against the Pallas kernel itself in
interpret mode.  Tolerances are those of tests/test_kernels.py: f32
2e-5, bf16 2e-2 (summation order differs between the two programs).
The CUDA kernel is held against the same plain version on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import paged_attention as jax_kernel
from repro.kernels import ref as jax_ref
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ref

TOL = {"f32": 2e-5, "bf16": 2e-2}

CASES = {  # name: (dtype, kv storage, Hkv, dk, dv, dr, window)
    "f32": ("f32", "same", 1, 32, 32, 0, 0),
    "bf16": ("bf16", "same", 1, 32, 32, 0, 0),
    "gqa_hkv2": ("f32", "same", 2, 32, 32, 0, 0),
    "window": ("f32", "same", 1, 32, 32, 0, 5),
    "dk_ne_dv": ("f32", "same", 1, 48, 24, 0, 0),
    "int8_scaled": ("f32", "int8", 1, 32, 32, 0, 0),
    "fp8_scaled": ("f32", "fp8", 2, 32, 32, 0, 0),
    "k_extra": ("f32", "same", 1, 32, 32, 16, 0),
    "int8_k_extra_window": ("f32", "int8", 1, 40, 40, 8, 7),
}


def make_case(name, seed=0, B=6, H=4, page=4, P=6):
    """numpy inputs: ragged lens (1 .. P*page), each row's live pages
    scattered over the pool, sentinel ids (n_pages and beyond) past
    them."""
    dt, kv, Hkv, dk, dv, dr, window = CASES[name]
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, P * page + 1, B)
    lens[0], lens[1] = 1, P * page
    live = -(-lens // page)
    n_pages = int(live.sum()) + 3
    perm = rng.permutation(n_pages)
    table = np.full((B, P), n_pages, np.int32)
    table[:, -1] = n_pages + 3
    at = 0
    for b, n in enumerate(live):
        table[b, :n] = perm[at:at + n]
        at += n
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    c = dict(q=f(B, H, dk + dr), k_pages=f(n_pages, page, Hkv, dk),
             v_pages=f(n_pages, page, Hkv, dv), table=table,
             lens=lens.astype(np.int32), window=window)
    if kv == "int8":
        c["k_pages"] = np.clip(np.round(c["k_pages"] * 40), -127, 127
                               ).astype(np.int8)
        c["v_pages"] = np.clip(np.round(c["v_pages"] * 40), -127, 127
                               ).astype(np.int8)
    if kv == "fp8":  # values already on the e4m3 grid: both sides exact
        for k in ("k_pages", "v_pages"):
            c[k] = c[k].astype(ml_dtypes.float8_e4m3fn).astype(np.float32)
    if kv in ("int8", "fp8"):
        c["k_scale"] = rng.uniform(0, 0.05, (n_pages, page, Hkv)
                                   ).astype(np.float32)
        c["v_scale"] = rng.uniform(0, 0.05, (n_pages, page, Hkv)
                                   ).astype(np.float32)
    if dr:
        c["k_extra"] = f(n_pages, page, Hkv, dr)
    return dt, kv, c


def to_jax(dt, kv, c):
    out = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in c.items()}
    if dt == "bf16":
        for k in ("q", "k_pages", "v_pages"):
            out[k] = out[k].astype(jnp.bfloat16)
    if kv == "fp8":
        for k in ("k_pages", "v_pages"):
            out[k] = out[k].astype(jnp.float8_e4m3fn)
    return out


def to_torch(dt, kv, c):
    out = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
           for k, v in c.items()}
    if dt == "bf16":
        for k in ("q", "k_pages", "v_pages"):
            out[k] = out[k].to(torch.bfloat16)
    if kv == "fp8":
        for k in ("k_pages", "v_pages"):
            out[k] = out[k].to(torch.float8_e4m3fn)
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_version_matches_jax_reference(name):
    dt, kv, c = make_case(name)
    want = np.asarray(jax_ref.paged_attention(**to_jax(dt, kv, c)),
                      np.float32)
    got = ref.paged_attention(**to_torch(dt, kv, c)).float().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=TOL[dt], rtol=TOL[dt])


@pytest.mark.parametrize("name", ["f32", "int8_k_extra_window"])
def test_plain_version_matches_pallas_kernel_interpret(name):
    dt, kv, c = make_case(name, seed=1, B=3)
    want = np.asarray(jax_kernel.paged_attention(**to_jax(dt, kv, c),
                                                 interpret=True))
    got = ref.paged_attention(**to_torch(dt, kv, c)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL[dt], rtol=TOL[dt])


def test_scale_argument_and_row_independence():
    """An explicit scale is honoured, and a row's output does not depend
    on the other rows in the batch."""
    dt, kv, c = make_case("f32", seed=2)
    want = np.asarray(jax_ref.paged_attention(**to_jax(dt, kv, c),
                                              scale=0.3))
    t = to_torch(dt, kv, c)
    got = ref.paged_attention(**t, scale=0.3).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    one = {k: (v[2:3] if k in ("q", "table", "lens") else v)
           for k, v in t.items()}
    np.testing.assert_allclose(ref.paged_attention(**one, scale=0.3).numpy(),
                               got[2:3], atol=1e-6, rtol=1e-6)


def test_ops_dispatches_cpu_tensors_to_plain_version():
    dt, kv, c = make_case("k_extra", seed=3)
    t = to_torch(dt, kv, c)
    assert torch.equal(ops.paged_attention(**t), ref.paged_attention(**t))


def test_kernel_wrapper_rejects_cpu_tensors():
    """The CUDA wrapper never quietly runs the plain version."""
    dt, kv, c = make_case("f32")
    with pytest.raises(ValueError, match="CUDA"):
        pa.paged_attention(**to_torch(dt, kv, c))
