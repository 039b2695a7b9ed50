"""Tests of the PyTorch port that need the card (marker `cuda`).

The hand-written CUDA paged-attention kernel against its plain PyTorch
version in every option, its input checks, and the engine on the card
against the engine on the CPU.  Each test skips where there is no CUDA
device.  No JAX import, so the file runs on a machine without JAX:

    python -m pytest tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ref
from repro_torch.models import transformer as tf
from repro_torch.serving.engine import EnsembleEngine

pytestmark = pytest.mark.cuda

# f32 2e-5, bf16 2e-2: the JAX package's kernel-test tolerances (the
# kernel sums an online softmax page by page, the plain version at once)
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}

CASES = {  # name: (q dtype, page dtype, Hkv, dk, dv, dr, window)
    "f32": (torch.float32, torch.float32, 1, 32, 32, 0, 0),
    "bf16": (torch.bfloat16, torch.bfloat16, 1, 32, 32, 0, 0),
    "gqa_hkv2": (torch.float32, torch.float32, 2, 32, 32, 0, 0),
    "window": (torch.float32, torch.float32, 1, 32, 32, 0, 5),
    "dk_ne_dv": (torch.float32, torch.float32, 1, 48, 24, 0, 0),
    "int8_scaled": (torch.float32, torch.int8, 1, 32, 32, 0, 0),
    "fp8_scaled": (torch.float32, torch.float8_e4m3fn, 2, 32, 32, 0, 0),
    "k_extra": (torch.float32, torch.float32, 1, 32, 32, 16, 0),
    "int8_odd_rows": (torch.float32, torch.int8, 1, 40, 40, 8, 7),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card, see README)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def make_case(name, dev, seed=0, B=6, H=4, page=4, P=6):
    qdt, kvdt, Hkv, dk, dv, dr, window = CASES[name]
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    lens = torch.randint(1, P * page + 1, (B,), generator=g, device=dev)
    lens[0], lens[1] = 1, P * page
    live = ((lens + page - 1) // page).tolist()
    n_pages = sum(live) + 3
    perm = torch.randperm(n_pages, generator=g, device=dev).int()
    table = torch.full((B, P), n_pages, dtype=torch.int32, device=dev)
    table[:, -1] = n_pages + 3
    at = 0
    for b, n in enumerate(live):
        table[b, :n] = perm[at:at + n]
        at += n

    def rnd(*shape, dtype):
        x = torch.randn(*shape, generator=g, device=dev)
        if dtype == torch.int8:
            return (x * 40).round().clamp(-127, 127).to(torch.int8)
        return x.to(dtype)

    c = dict(q=rnd(B, H, dk + dr, dtype=qdt),
             k_pages=rnd(n_pages, page, Hkv, dk, dtype=kvdt),
             v_pages=rnd(n_pages, page, Hkv, dv, dtype=kvdt),
             table=table, lens=lens.int(), window=window)
    if kvdt in (torch.int8, torch.float8_e4m3fn):
        c["k_scale"] = torch.rand(n_pages, page, Hkv, generator=g,
                                  device=dev) * 0.05
        c["v_scale"] = torch.rand(n_pages, page, Hkv, generator=g,
                                  device=dev) * 0.05
    if dr:
        c["k_extra"] = rnd(n_pages, page, Hkv, dr, dtype=qdt)
    return c


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_matches_plain_version(cuda, name):
    c = make_case(name, cuda)
    before = pa.paged_attention.launches
    got = pa.paged_attention(**c)
    torch.cuda.synchronize()
    assert pa.paged_attention.launches == before + 1
    want = ref.paged_attention(**c)
    tol = TOL[c["q"].dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol,
                               rtol=tol)


def test_kernel_checks_its_inputs(cuda):
    c = make_case("f32", cuda)
    for bad, match in ((dict(table=c["table"].long()), "table dtype"),
                       (dict(lens=c["lens"][:-1]), "lens has shape"),
                       (dict(q=c["q"].transpose(0, 1).contiguous()
                             .transpose(0, 1)), "contiguous"),
                       (dict(q=c["q"][..., :-1].contiguous()), "features")):
        with pytest.raises(ValueError, match=match):
            pa.paged_attention(**dict(c, **bad))


def test_engine_on_card_matches_cpu(cuda):
    cfg = registry.get_config("gemma3-1b", reduced=True).with_(
        dtype="float32")
    params = tf.init(cfg, seed=0, device="cpu", members=2)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (3, 11, 16)]
    outs = []
    for dev in (cuda, "cpu"):
        eng = EnsembleEngine(cfg, params, n_slots=3, max_prompt=16,
                             max_out=12, paged=True, page_size=4,
                             device=dev)
        outs.append(eng.generate(prompts, 10))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
