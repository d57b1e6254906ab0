"""The serving path's routing through the flash-attention kernel, the
serve launcher for every family, and each family's smoke model on the
card against the CPU.  No jax here, so the ``gpu`` cases run on a machine with
only PyTorch; they decide inside the test whether a card exists.

On the card the kernel and the plain q-chunked route differ only by f32
summation order: f32 attention within 1e-5 rel L2, f32 smoke-model logits
(card against CPU, cuBLAS against CPU products as well) within 1e-4.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.configs.yi_6b import SMOKE_CONFIG as YI_SMOKE
from repro_torch.kernels import flash_attn as fa
from repro_torch.launch import serve
from repro_torch.models import layers as tl
from repro_torch.models import transformer as tt
from repro_torch.serve.engine import ServeEngine


def _rel(a, b):
    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def _qkv(T, S, device, seed=0, d=32):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((2, 8, T, d), generator=g)
    k = torch.randn((2, 2, S, d), generator=g)
    v = torch.randn((2, 2, S, d), generator=g)
    return q.to(device), k.to(device), v.to(device)


def _to(tree, device):
    if torch.is_tensor(tree):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return [_to(v, device) for v in tree]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def test_attention_core_on_cpu_takes_the_plain_route():
    q, k, v = _qkv(40, 40, "cpu")
    before = (fa.LAUNCHES, fa.TC_LAUNCHES, fa.TF32_LAUNCHES)
    out = tl.attention_core(q, k, v, causal=True, q_chunk=8)
    assert (fa.LAUNCHES, fa.TC_LAUNCHES, fa.TF32_LAUNCHES) == before
    torch.testing.assert_close(out, tl.attention_core_plain(q, k, v, q_chunk=8),
                               rtol=0, atol=0)


def test_launcher_serves_on_cpu(capsys):
    out = serve.main(["--arch", "yi-6b", "--local", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "16", "--new", "3"])
    assert out.shape == (2, 3) and out.dtype == np.int32
    assert "[serve] generated (2, 3) tokens" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "recurrentgemma-2b",
                                  "mamba2-1.3b", "musicgen-large", "internvl2-26b"])
def test_launcher_serves_every_family_on_cpu(arch, capsys):
    out = serve.main(["--arch", arch, "--local", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "40", "--new", "3"])
    assert out.shape == (2, 3) and out.dtype == np.int32
    assert "[serve] generated (2, 3) tokens" in capsys.readouterr().out


def test_launcher_refuses_an_arch_that_is_not_a_language_model():
    with pytest.raises(SystemExit):
        serve.main(["--arch", "petfmm-vortex", "--local", "--device", "cpu"])


@pytest.mark.gpu
@pytest.mark.parametrize("T,S,kwargs,launches", [
    (100, 100, {}, 1),                          # the kernel's case
    (100, 100, {"window": 16}, 0),              # local attention: plain
    (60, 100, {"q_offset": 40}, 0),             # chunked prefill: plain
    (100, 100, {"score_dtype": torch.bfloat16}, 0),
    (100, 100, {"window": 128}, 1),             # a window over every key: the kernel
    (100, 100, {"d": 20}, 0),                   # a head dim no kernel takes: plain
])
def test_attention_core_routes_by_arguments(cuda, T, S, kwargs, launches):
    kwargs = dict(kwargs)
    q, k, v = _qkv(T, S, cuda, d=kwargs.pop("d", 32))
    before = fa.LAUNCHES
    got = tl.attention_core(q, k, v, causal=True, q_chunk=32, **kwargs)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before + launches
    want = tl.attention_core_plain(q, k, v, causal=True, q_chunk=32, **kwargs)
    tol = 2e-2 if kwargs.get("score_dtype") == torch.bfloat16 else 1e-5
    assert _rel(got, want) < tol


@pytest.mark.gpu
def test_smoke_model_on_card_matches_cpu(cuda):
    cfg = dataclasses.replace(YI_SMOKE, dtype="float32")
    params = tt.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    on_card = _to(params, cuda)
    tokens = torch.tensor(np.random.default_rng(0).integers(0, cfg.vocab, (2, 70)))
    before = fa.LAUNCHES
    hc, _ = tt.forward(on_card, tokens.to(cuda), cfg)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before + cfg.num_layers
    h, _ = tt.forward(params, tokens, cfg)
    assert _rel(tt.unembed(on_card, hc, cfg), tt.unembed(params, h, cfg)) < 1e-4

    engine = ServeEngine(on_card, cfg, batch_slots=2, max_len=80, device=cuda)
    before = fa.LAUNCHES
    out = engine.step_all(tokens[:, :64].numpy(), 5)
    assert fa.LAUNCHES == before + cfg.num_layers      # prefill only
    assert out.shape == (2, 5)


FAMILY_SMOKES = ["granite-moe-1b-a400m", "qwen3-moe-235b-a22b", "recurrentgemma-2b",
                 "mamba2-1.3b", "musicgen-large", "internvl2-26b", "command-r-35b",
                 "qwen1.5-32b"]


@pytest.mark.gpu
@pytest.mark.parametrize("arch", FAMILY_SMOKES)
def test_family_smoke_model_on_card_matches_cpu(cuda, arch):
    """Each family's smoke model in f32 on the card against the CPU, over 30
    positions (within the hybrid's window of 32, so its local attention
    takes the kernel): one flash launch for each attention layer, none at
    a head dim no kernel takes (qwen1.5-32b's smoke config: 20)."""
    cfg = dataclasses.replace(registry.get_smoke_config(arch), dtype="float32")
    params = tt.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    on_card = _to(params, cuda)
    tokens = torch.tensor(np.random.default_rng(1).integers(0, cfg.vocab, (2, 30)))
    pe = (torch.randn((2, cfg.num_patches, cfg.patch_dim),
                      generator=torch.Generator().manual_seed(2))
          if cfg.num_patches else None)
    attn_layers = sum(k in ("attn", "moe") for k in tt.layer_kinds(cfg))
    if not fa.takes_head_dim(cfg.head_dim_):
        attn_layers = 0
    before = fa.LAUNCHES + fa.TC_LAUNCHES + fa.TF32_LAUNCHES
    hc, _ = tt.forward(on_card, tokens.to(cuda), cfg,
                       patch_embeds=None if pe is None else pe.to(cuda))
    torch.cuda.synchronize()
    assert fa.LAUNCHES + fa.TC_LAUNCHES + fa.TF32_LAUNCHES == before + attn_layers
    h, _ = tt.forward(params, tokens, cfg, patch_embeds=pe)
    assert _rel(tt.unembed(on_card, hc, cfg), tt.unembed(params, h, cfg)) < 1e-4
