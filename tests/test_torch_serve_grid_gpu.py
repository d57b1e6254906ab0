"""Serving on a grid of ranks on the card: 4 gloo ranks sharing one card as
a ``(2, 2)`` grid serve granite-moe's smoke config (the KV caches split by
heads; capacity factor ``E / k``, nothing drops) and recurrentgemma-2b's
(1 KV head: split by sequence) in f32, prompts of 24 tokens (within
recurrentgemma's smoke window of 32, where the flash kernel is its
attention).  No jax.

On every rank the prefill logits lie within 1e-4 rel L2 of the one-rank
engine's on the card (the flash kernels and cuBLAS against the same kernels
on other head counts, and all-reduced partial sums), the greedy tokens of
``step_all`` equal the one-rank engine's, and each rank launches exactly
one flash kernel a prefill attention layer (its own query heads) and none
in decode; the ranks' schedules verify.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.analysis.schedule import verify_schedules
from repro_torch.configs import registry
from repro_torch.kernels import flash_attn as fa
from repro_torch.launch.mesh import make_grid_mesh, spawn_world
from repro_torch.models import transformer as tt
from repro_torch.serve import engine as te
from repro_torch.serve import grid as sg

ARCHS = ["granite-moe-1b-a400m", "recurrentgemma-2b"]
B, T, MAX_LEN, NEW = 4, 24, 48, 4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _cfg(arch):
    cfg = dataclasses.replace(registry.get_smoke_config(arch), dtype="float32")
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
    return cfg


def _launches() -> int:
    return fa.LAUNCHES + fa.TC_LAUNCHES + fa.TF32_LAUNCHES


def _serve(cfg, device, mesh=None):
    params = _to(tt.init_params(cfg, torch.Generator().manual_seed(0), "cpu"), device)
    if mesh is not None:
        params = sg.param_blocks(params, cfg, mesh)
    prompts = np.random.default_rng(7).integers(0, cfg.vocab, (B, T)).astype(np.int32)
    eng = te.ServeEngine(params, cfg, batch_slots=B, max_len=MAX_LEN, device=device, mesh=mesh)
    logits, _ = eng.prefill_fn(params, torch.as_tensor(prompts, device=device).long(),
                               eng.init_cache(B))
    before = _launches()
    tokens = eng.step_all(prompts, NEW)
    return {"logits": logits.cpu(), "tokens": tokens, "launches": _launches() - before}


def _to(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return [_to(v, device) for v in tree]


def _rank(world):
    grid = make_grid_mesh((2, 2), ("data", "model"), device="cuda")
    out = {arch: _serve(_cfg(arch), grid.device, grid) for arch in ARCHS}
    out["log"] = list(grid.log.events)
    return out


@pytest.mark.gpu
def test_grid_serve_on_the_card_matches_one_rank(cuda):
    one = {arch: _serve(_cfg(arch), cuda) for arch in ARCHS}
    ranks = spawn_world(_rank, 4, device="cuda", timeout_s=300)
    for arch in ARCHS:
        cfg = _cfg(arch)
        attn = sum(k != "rglru" and k != "mamba" for k in tt.layer_kinds(cfg))
        assert one[arch]["launches"] == attn
        for rk in ranks:
            got, want = rk[arch]["logits"].double(), one[arch]["logits"].double()
            assert float((got - want).norm() / want.norm()) < 1e-4, arch
            np.testing.assert_array_equal(rk[arch]["tokens"], one[arch]["tokens"])
            assert rk[arch]["launches"] == attn, (arch, rk[arch]["launches"])
    assert verify_schedules([rk["log"] for rk in ranks]).ok
