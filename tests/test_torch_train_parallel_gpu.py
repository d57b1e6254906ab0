"""A grid step on the card: 4 gloo ranks sharing one card as a ``(2, 2)``
grid take one step of granite-moe's smoke config in f32 at capacity factor
``E / k`` (nothing drops), and the same step on 4 CPU ranks.  No jax.

The card's step equals the CPU's within 1e-4 rel L2 a parameter, and its
loss and grad norm within 1e-5 relative (cuBLAS and the flash kernel
against CPU sums, three layers deep); every rank launches its attention
route's kernel exactly twice a layer (forward and remat's recompute) and
no other; the ranks' schedules verify and equal the CPU ranks' event for
event.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.analysis.schedule import same_schedule, verify_schedules
from repro_torch.configs import registry
from repro_torch.kernels import flash_attn as fa
from repro_torch.launch.mesh import make_grid_mesh, spawn_world
from repro_torch.models.transformer import init_params, param_tensors
from repro_torch.optim.adamw import AdamWConfig, init_state
from repro_torch.parallel import sharding as shd
from repro_torch.train import loop as tloop

OPT = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _cfg():
    cfg = dataclasses.replace(registry.get_smoke_config("granite-moe-1b-a400m"),
                              dtype="float32")
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))


def _rank(world_mesh, device):
    mesh = make_grid_mesh((2, 2), ("data", "model"), device=device)
    cfg = _cfg()
    full = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    specs = tloop.tree_specs(full, tloop.grid_specs(cfg, mesh))
    blocks = tloop.unflatten(full, [shd.local_block(t, s, mesh).clone().to(device)
                                    for t, s in zip(param_tensors(full), specs)])
    g = torch.Generator().manual_seed(1)
    tok = torch.randint(0, cfg.vocab, (4, 64), generator=g)
    batch = {"tokens": tok, "labels": torch.cat([tok[:, 1:], torch.full((4, 1), -1)], 1)}
    batch = {k: v.to(device) for k, v in tloop.local_rows(batch, mesh).items()}
    fa.LAUNCHES = fa.TC_LAUNCHES = fa.TF32_LAUNCHES = 0
    step = tloop.make_train_step(cfg, OPT, mesh, q_chunk=16, loss_chunk=16)
    blocks, _, m = step(blocks, init_state(blocks, OPT), batch)
    launches = {"tc": fa.TC_LAUNCHES, "tf32": fa.TF32_LAUNCHES, "simt": fa.LAUNCHES}
    return {"loss": float(m["loss"]), "gnorm": float(m["grad_norm"]),
            "params": [shd.gather_full(t, s, mesh).cpu()
                       for t, s in zip(param_tensors(blocks), specs)],
            "launches": launches, "log": list(mesh.log.events)}


@pytest.mark.gpu
def test_grid_step_on_the_card_equals_the_cpu_grid_step(cuda):
    card = spawn_world(_rank, 4, device="cuda", timeout_s=300, args=("cuda",))
    cpu = spawn_world(_rank, 4, device="cpu", timeout_s=300, args=("cpu",))
    layers = _cfg().num_layers
    for c, h in zip(card, cpu):
        assert abs(c["loss"] - h["loss"]) <= 1e-5 * h["loss"]
        assert abs(c["gnorm"] - h["gnorm"]) <= 1e-5 * h["gnorm"]
        for a, b in zip(c["params"], h["params"]):
            a, b = a.double(), b.double()
            assert float((a - b).norm() / b.norm()) < 1e-4
        got = {k: v for k, v in c["launches"].items() if v}
        assert list(got.values()) == [2 * layers], c["launches"]
        assert same_schedule(c["log"], h["log"]) is None
    assert verify_schedules([c["log"] for c in card]).ok
    assert all(np.isfinite(c["loss"]) for c in card)
