"""Training on the card: the flash kernel inside autograd, and the
recurrent families' steps.  No jax here; the ``gpu`` cases decide inside
the test whether a card exists and compare with the port's own plain
versions or its CPU run.

Tolerances: the forward through ``ops.flash_attention_with_grad`` against
``attention_core_plain``'s on the card within 1e-5 rel L2 in f32 (3xTF32
or f32 sums in another order) and 5e-3 in bf16 (bf16 outputs), the
kernel's own gates; the q, k and v gradients within 1e-5 in f32 and 1e-3
in bf16 (the backward recomputes the plain version, so both are plain f32
sums rounded once to the dtype: this holds the wiring); a smoke model's loss
and gradients on the card against the CPU within 1e-4 rel L2 (cuBLAS and
the kernels against CPU sums, a few layers deep).
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import registry
from repro_torch.data.pipeline import PipelineState, make_batch, make_inputs
from repro_torch.kernels import flash_attn as fa
from repro_torch.kernels import ops
from repro_torch.models import layers as tl
from repro_torch.models.config import ShapeConfig
from repro_torch.models.transformer import init_params, param_tensors
from repro_torch.optim.adamw import AdamWConfig, init_state
from repro_torch.train import loop as tloop
from repro_torch.train.loop import Trainer, TrainerConfig

SHAPE = ShapeConfig("t", "train", 64, 2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rel(a, b):
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def _to(tree, device):
    return tloop.unflatten(tree, [t.to(device) for t in param_tensors(tree)])


def _counts():
    return {"tc": fa.TC_LAUNCHES, "tf32": fa.TF32_LAUNCHES, "simt": fa.LAUNCHES}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,head_dim,route", [("bfloat16", 64, "tc"),
                                                  ("float32", 64, "tf32"),
                                                  ("float32", 16, "simt")])
def test_train_step_on_the_card_reaches_every_attention_weight(cuda, dtype, head_dim, route):
    """A small dense model's step with remat: the route's kernel twice a
    layer (forward and recompute), none on another route, and a nonzero
    gradient for every layer's w_q, w_k and w_v."""
    cfg = dataclasses.replace(registry.get_smoke_config("yi-6b"), dtype=dtype,
                              head_dim=head_dim)
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    batch = make_inputs(PipelineState(0, 0), cfg, SHAPE, cuda)
    torch.cuda.synchronize()
    before = _counts()
    loss, grads = tloop.value_and_grad(tloop.make_loss_fn(cfg, remat=True), params, batch)
    torch.cuda.synchronize()
    made = {r: _counts()[r] - before[r] for r in before}
    assert made == {r: 2 * cfg.num_layers * (r == route) for r in made}
    g = tloop.unflatten(params, grads)
    for layer in g["layers"]:
        for name in ("w_q", "w_k", "w_v"):
            assert bool(torch.isfinite(layer["attn"][name]).all())
            assert float(layer["attn"][name].abs().max()) > 0, name
    step = tloop.make_train_step(cfg, AdamWConfig(lr=1e-3, total_steps=4))
    _, _, m = step(params, init_state(params), batch)
    assert torch.isfinite(m["loss"]) and float(m["grad_norm"]) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,fwd_tol,tol", [(torch.bfloat16, 5e-3, 1e-3),
                                               (torch.float32, 1e-5, 1e-5)])
def test_kernel_gradients_match_the_plain_version_on_the_card(cuda, dtype, fwd_tol, tol):
    g = torch.Generator(device=cuda).manual_seed(1)
    q, k, v = (torch.randn(s, generator=g, device=cuda).to(dtype).requires_grad_()
               for s in ((2, 8, 128, 64), (2, 2, 128, 64), (2, 2, 128, 64)))
    w = torch.randn((2, 8, 128, 64), generator=g, device=cuda)
    out, want_out = tl.attention_core(q, k, v), tl.attention_core_plain(q, k, v)
    assert out.dtype == dtype and _rel(out, want_out) < fwd_tol
    got = torch.autograd.grad((out.float() * w).sum(), (q, k, v))
    want = torch.autograd.grad((want_out.float() * w).sum(), (q, k, v))
    for a, b in zip(got, want):
        assert a.dtype == dtype and _rel(a, b) < tol
    with torch.inference_mode():
        before = _counts()
        ops.flash_attention_with_grad(q.detach(), k.detach(), v.detach())
        assert sum(_counts()[r] - before[r] for r in before) == 1


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "mamba2-1.3b"])
def test_recurrent_smoke_models_step_on_the_card(cuda, arch):
    """f32 smoke models: loss and every gradient on the card as on the CPU
    (recurrentgemma's local attention over 32 positions, within its window
    of 32: the simt kernel at d = 32), then a step."""
    cfg = dataclasses.replace(registry.get_smoke_config(arch), dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = make_inputs(PipelineState(0, 0), cfg, ShapeConfig("t", "train", 32, 2), "cpu")
    loss_fn = tloop.make_loss_fn(cfg, q_chunk=16, loss_chunk=16)
    want_loss, want = tloop.value_and_grad(loss_fn, params, batch)
    on_card = _to(params, cuda)
    loss, grads = tloop.value_and_grad(loss_fn, on_card, {k: v.to(cuda) for k, v in batch.items()})
    assert abs(float(loss) - float(want_loss)) < 1e-4 * float(want_loss)
    for a, b in zip(grads, want):
        assert bool(torch.isfinite(a).all()) and _rel(a, b) < 1e-4
    step = tloop.make_train_step(cfg, AdamWConfig(lr=1e-3, total_steps=4), q_chunk=16,
                                 loss_chunk=16)
    _, _, m = step(on_card, init_state(on_card), {k: v.to(cuda) for k, v in batch.items()})
    assert torch.isfinite(m["loss"])


@pytest.mark.gpu
def test_pipeline_gives_the_same_batch_on_any_device(cuda):
    cfg = registry.get_smoke_config("internvl2-26b")
    a = make_inputs(PipelineState(3, 5), cfg, SHAPE, cuda)
    b = make_inputs(PipelineState(3, 5), cfg, SHAPE, "cpu")
    assert all(a[k].is_cuda and torch.equal(a[k].cpu(), b[k]) for k in a)
    t, _ = make_batch(PipelineState(3, 5), cfg, 2, 8, cuda)
    assert torch.equal(t.cpu(), make_batch(PipelineState(3, 5), cfg, 2, 8, "cpu")[0])


@pytest.mark.gpu
def test_trainer_on_the_card_resumes_bit_for_bit(cuda, tmp_path):
    """The Trainer's default device is the card: 4 steps straight, and 2
    steps, a checkpoint and 2 more in a new Trainer, give the same bits."""
    cfg = registry.get_smoke_config("yi-6b")

    def trainer(where, steps):
        return Trainer(cfg, SHAPE, AdamWConfig(lr=1e-3, total_steps=4),
                       TrainerConfig(steps=steps, ckpt_every=2, ckpt_dir=str(tmp_path / where)))
    whole = trainer("a", 4)
    whole.run()
    assert whole.device.type == "cuda"
    trainer("b", 2).run()
    resumed = trainer("b", 4)
    assert resumed.try_restore() and resumed.pipeline.step == 2
    resumed.run()
    assert [m["loss"] for m in resumed.metrics_log] == [m["loss"] for m in whole.metrics_log[2:]]
    for a, b in zip(param_tensors([whole.params, whole.opt_state]),
                    param_tensors([resumed.params, resumed.opt_state])):
        assert torch.equal(a, b)
