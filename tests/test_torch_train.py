"""The port's training slice against the reference, on the CPU:
``lm_loss``, ``optim/adamw.py``, ``data/pipeline.py``'s contract,
``make_train_step`` (one and two microbatches), ``probe_expert_load``,
``Trainer`` (each of ``tests/test_train.py``'s cases that needs no mesh)
and a reference ``Trainer`` checkpoint resumed in the port's.

Inputs are made with numpy from a seed, and weights come from the
reference's ``init_params`` through ``convert.params_from_jax`` where the
two are compared.  Tolerances: f32 values within 1e-6 relative (1e-5 where
sums of several layers run in another order); a schedule's learning rate
within 1e-6 relative; probe counts and the int8 codes exactly; the
Trainer's own cases as the reference's test states them.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import registry as jreg
from repro.data import pipeline as jpipe
from repro.models import transformer as jt
from repro.optim import adamw as jopt
from repro.train import loop as jloop

from repro_torch.checkpoint import manager as M
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import registry
from repro_torch.data.pipeline import PipelineState, advance, make_batch, make_inputs
from repro_torch.models.config import ShapeConfig
from repro_torch.models.convert import params_from_jax
from repro_torch.models.transformer import lm_loss, param_tensors
from repro_torch.optim import adamw as topt
from repro_torch.parallel.sharding import flat_names
from repro_torch.train import loop as tloop
from repro_torch.train.loop import Trainer, TrainerConfig

CPU = torch.device("cpu")
TINY = ShapeConfig("tiny", "train", seq_len=32, global_batch=2)


def _rel(a, b) -> float:
    a = a.detach().double().numpy() if torch.is_tensor(a) else np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _f32(reg, arch):
    return dataclasses.replace(reg.get_smoke_config(arch), dtype="float32")


def _weights(arch, seed=0):
    """(port cfg, reference cfg, port params, reference params), f32."""
    jcfg = _f32(jreg, arch)
    pnp = jax.tree.map(np.asarray, jt.init_params(jax.random.PRNGKey(seed), jcfg))
    cfg = _f32(registry, arch)
    return cfg, jcfg, params_from_jax(pnp, cfg, CPU), jax.tree.map(jnp.asarray, pnp)


def _batch_np(cfg, B=4, T=32, seed=1):
    tokens = np.random.default_rng(seed).integers(0, cfg.vocab, (B, T)).astype(np.int32)
    labels = np.concatenate([tokens[:, 1:], np.full((B, 1), -1, np.int32)], axis=1)
    return {"tokens": tokens, "labels": labels}


def _torch_batch(batch):
    return {k: torch.tensor(v).long() if v.dtype.kind == "i" else torch.tensor(v)
            for k, v in batch.items()}


# ---------------------------------------------------------------------------
# lm_loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tied,chunk", [(False, 8), (True, 8), (False, 7)])
def test_lm_loss_value_and_gradients_match_the_reference(tied, chunk):
    """Masked labels, tied and untied embeddings, and a chunk that does
    not divide T (24 positions: one chunk of all)."""
    cfg = dataclasses.replace(_f32(registry, "yi-6b"), tie_embeddings=tied, vocab=50)
    jcfg = dataclasses.replace(_f32(jreg, "yi-6b"), tie_embeddings=tied, vocab=50)
    rng = np.random.default_rng(2)
    hidden = rng.normal(size=(2, 24, cfg.d_model)).astype(np.float32)
    W = (rng.normal(size=(50, cfg.d_model)) * 0.05).astype(np.float32)
    labels = rng.integers(0, 50, (2, 24)).astype(np.int32)
    labels[0, 5:9] = -1
    labels[1, -1] = -1
    name = "embed" if tied else "lm_head"

    def jloss(h, w):
        return jt.lm_loss({name: w}, h, jnp.asarray(labels), jcfg, chunk=chunk)
    want, (wh, ww) = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(hidden),
                                                               jnp.asarray(W))
    h, w = torch.tensor(hidden, requires_grad=True), torch.tensor(W, requires_grad=True)
    got = lm_loss({name: w}, h, torch.tensor(labels).long(), cfg, chunk=chunk)
    gh, gw = torch.autograd.grad(got, (h, w))
    assert abs(float(got.detach()) - float(want)) < 1e-6 * float(want)
    assert _rel(gh, wh) < 1e-6 and _rel(gw, ww) < 1e-6


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def test_schedule_matches_the_reference():
    cfg = topt.AdamWConfig(lr=2.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    jcfg = jopt.AdamWConfig(lr=2.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    for step in (0, 3, 10, 55, 100, 130):      # warmup, peak, decay, end, past it
        got = float(topt.schedule(cfg, torch.tensor(step, dtype=torch.int32)))
        want = float(jopt.schedule(jcfg, jnp.int32(step)))
        assert abs(got - want) <= 1e-6 * abs(want)
    assert float(topt.schedule(cfg, torch.tensor(10))) == pytest.approx(2.0, rel=1e-6)
    assert float(topt.schedule(cfg, torch.tensor(100))) == pytest.approx(0.2, rel=1e-5)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_init_state_and_global_norm(state_dtype):
    cfg, _, params, pj = _weights("yi-6b")
    st = topt.init_state(params, topt.AdamWConfig(state_dtype=state_dtype))
    jst = jopt.init_state(pj, jopt.AdamWConfig(state_dtype=state_dtype))
    for mu, jmu in zip(param_tensors(st["mu"]), param_tensors(params)):
        assert mu.dtype == getattr(torch, state_dtype) and mu.shape == jmu.shape
        assert not mu.any()
    assert st["step"].dtype == torch.int32 and int(st["step"]) == 0 == int(jst["step"])
    assert str(jax.tree.leaves(jst["mu"])[0].dtype) == state_dtype
    assert abs(float(topt.global_norm(params)) - float(jopt.global_norm(pj))) < 1e-6 * float(
        jopt.global_norm(pj))


@pytest.mark.parametrize("clip", [1e9, 0.05])
def test_two_apply_updates_steps_match_the_reference(clip):
    """Clipping off, and on (the gradients' norm is about 7)."""
    cfg, _, params, pj = _weights("yi-6b")
    ocfg = topt.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=4, clip_norm=clip)
    jocfg = jopt.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=4, clip_norm=clip)
    rng = np.random.default_rng(5)
    st, jst = topt.init_state(params, ocfg), jopt.init_state(pj, jocfg)
    for _ in range(2):
        gnp = [rng.normal(scale=0.01, size=t.shape).astype(np.float32)
               for t in param_tensors(params)]
        grads = tloop.unflatten(params, [torch.tensor(g) for g in gnp])
        jgrads = jax.tree.unflatten(jax.tree.structure(pj), [
            jnp.asarray(g) for g in _reference_order(gnp, params, pj)])
        params, st, m = topt.apply_updates(params, grads, st, ocfg)
        pj, jst, jm = jopt.apply_updates(pj, jgrads, jst, jocfg)
        assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) < 1e-5 * float(jm["grad_norm"])
        assert float(m["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
    assert int(st["step"]) == 2
    want = params_from_jax(jax.tree.map(np.asarray, pj), cfg, CPU)
    for got, w in zip(param_tensors(params), param_tensors(want)):
        assert _rel(got, w.numpy()) < 1e-6
    for key in ("mu", "nu"):
        want = params_from_jax(jax.tree.map(np.asarray, jst[key]), cfg, CPU)
        for got, w in zip(param_tensors(st[key]), param_tensors(want)):
            assert _rel(got, w.numpy()) < 1e-5


def _reference_order(flat_port, params, pj):
    """Port-ordered leaves (a dense smoke model: one scan group) in the
    reference's leaf order, stacked over layers."""
    names = _paths(params)
    by_name = dict(zip(names, flat_port))
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(pj)[0]:
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        if keys[0] == "groups":
            sub = "/".join(str(k) for k in keys[3:])
            out.append(np.stack([by_name[f"layers/{i}/{sub}"] for i in range(leaf.shape[0])]))
        else:
            out.append(by_name["/".join(str(k) for k in keys)])
    return out


def _paths(tree, prefix=()):
    if isinstance(tree, torch.Tensor):
        return ["/".join(prefix)]
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    return [p for k, v in items for p in _paths(v, prefix + (str(k),))]


def test_compress_decompress_with_error_feedback_matches_the_reference():
    rng = np.random.default_rng(0)
    g = rng.normal(size=(256,)).astype(np.float32)
    err, jerr = torch.zeros(256), jnp.zeros(256)
    acc = torch.zeros(256)
    for _ in range(50):
        gh, err = topt.compress_decompress(torch.tensor(g), err)
        jgh, jerr = jopt.compress_decompress(jnp.asarray(g), jerr)
        # within f32 rounding, so the int8 codes agree (one code apart is
        # a whole quantum, max |g| / 127 ~ 0.02, apart)
        np.testing.assert_allclose(gh.numpy(), np.asarray(jgh), rtol=0, atol=1e-6)
        np.testing.assert_allclose(err.numpy(), np.asarray(jerr), rtol=0, atol=1e-6)
        acc += gh
    np.testing.assert_allclose((acc / 50).numpy(), g, atol=2e-2)


# ---------------------------------------------------------------------------
# the data pipeline's contract
# ---------------------------------------------------------------------------


def test_pipeline_deterministic_restart_safe_and_shifted():
    cfg = registry.get_smoke_config("yi-6b")
    s0 = PipelineState(seed=7, step=3)
    a1, l1 = make_batch(s0, cfg, 4, 16, device="cpu")
    a2, l2 = make_batch(PipelineState(seed=7, step=3), cfg, 4, 16, device="cpu")
    assert torch.equal(a1, a2) and torch.equal(l1, l2)
    b1, _ = make_batch(advance(s0), cfg, 4, 16, device="cpu")
    c1, _ = make_batch(PipelineState(seed=8, step=3), cfg, 4, 16, device="cpu")
    assert not torch.equal(a1, b1) and not torch.equal(a1, c1)
    assert torch.equal(l1[:, :-1], a1[:, 1:]) and bool((l1[:, -1] == -1).all())
    big, _ = make_batch(s0, cfg, 8, 512, device="cpu")
    assert int(big.min()) >= 0 and int(big.max()) < cfg.vocab
    assert int(big.max()) == cfg.vocab - 1 and int(big.min()) == 0
    # the reference's contract on the same state, to compare like with like
    ja, jl = jpipe.make_batch(jpipe.PipelineState(seed=7, step=3),
                              jreg.get_smoke_config("yi-6b"), 4, 16)
    np.testing.assert_array_equal(np.asarray(jl)[:, :-1], np.asarray(ja)[:, 1:])


def test_pipeline_vlm_inputs_have_the_references_shapes():
    cfg = registry.get_smoke_config("internvl2-26b")
    shape = ShapeConfig("t", "train", 48, 2)
    got = make_inputs(PipelineState(0, 0), cfg, shape, device="cpu")
    want = jpipe.make_inputs(jpipe.PipelineState(0, 0), jreg.get_smoke_config("internvl2-26b"),
                             shape)
    assert sorted(got) == sorted(want)
    for k in got:
        assert tuple(got[k].shape) == tuple(want[k].shape)
    assert got["tokens"].shape[1] == 48 - cfg.num_patches
    assert got["patch_embeds"].dtype == torch.float32
    again = make_inputs(PipelineState(0, 0), cfg, shape, device="cpu")
    assert all(torch.equal(got[k], again[k]) for k in got)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


def _one_step(n, arch="yi-6b"):
    cfg, jcfg, params, pj = _weights(arch)
    ocfg, jocfg = topt.AdamWConfig(lr=1e-3, total_steps=10), jopt.AdamWConfig(
        lr=1e-3, total_steps=10)
    batch = _batch_np(cfg)
    step = tloop.make_train_step(cfg, ocfg, num_microbatches=n, q_chunk=16, loss_chunk=16)
    got = step(params, topt.init_state(params, ocfg), _torch_batch(batch))
    jstep = jax.jit(jloop.make_train_step(jcfg, None, jocfg, num_microbatches=n,
                                          q_chunk=16, loss_chunk=16))
    pj2, _, jm = jstep(pj, jopt.init_state(pj, jocfg), {k: jnp.asarray(v) for k, v in batch.items()})
    return cfg, got, params_from_jax(jax.tree.map(np.asarray, pj2), cfg, CPU), jm


@pytest.mark.parametrize("n", [1, 2])
def test_train_step_matches_the_reference(n):
    """One step from the same weights and batch, one microbatch and two:
    the same metrics and new parameters.  The first step's update is about
    lr * sign(g) (lr 1e-5 in warmup), so a parameter whose gradient is
    nearly zero may move the other way in either package: within 2 lr."""
    cfg, (params, st, m), want, jm = _one_step(n)
    for k in ("loss", "grad_norm", "lr"):
        assert abs(float(m[k]) - float(jm[k])) <= 1e-5 * abs(float(jm[k])), k
    for got, w in zip(param_tensors(params), param_tensors(want)):
        assert float((got - w).abs().max()) <= 2 * float(m["lr"]) + 1e-7
        assert _rel(got, w.numpy()) < 1e-5
    assert int(st["step"]) == 1


def test_two_microbatches_equal_the_full_batch():
    """Labels hold the same count in each half, so the mean of the halves'
    means is the full mean, and so is each gradient."""
    cfg, jcfg, params, _ = _weights("yi-6b")
    ocfg = topt.AdamWConfig(lr=1e-3, total_steps=10)
    batch = _torch_batch(_batch_np(cfg))
    out = {}
    for n in (1, 2):
        p = tloop.unflatten(params, [t.clone() for t in param_tensors(params)])
        out[n] = tloop.make_train_step(cfg, ocfg, num_microbatches=n, q_chunk=16,
                                       loss_chunk=16)(p, topt.init_state(p, ocfg), batch)
    assert abs(float(out[1][2]["loss"]) - float(out[2][2]["loss"])) < 1e-6
    assert abs(float(out[1][2]["grad_norm"]) / float(out[2][2]["grad_norm"]) - 1) < 1e-5
    for a, b in zip(param_tensors(out[1][0]), param_tensors(out[2][0])):
        assert float((a - b).abs().max()) <= 2 * float(out[1][2]["lr"]) + 1e-7
    with pytest.raises(ValueError, match="microbatches"):
        tloop.make_train_step(cfg, ocfg, num_microbatches=3)(params, topt.init_state(params),
                                                             batch)


def test_probe_expert_load_counts_equal_the_references():
    cfg, jcfg, params, pj = _weights("granite-moe-1b-a400m")
    batch = _batch_np(cfg, B=4, T=48, seed=6)
    got = tloop.probe_expert_load(params, _torch_batch(batch), cfg)
    want = jloop.probe_expert_load(pj, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert got.sum() == 4 * 48 * cfg.moe.top_k


# ---------------------------------------------------------------------------
# Trainer (tests/test_train.py's cases that need no mesh)
# ---------------------------------------------------------------------------


def _trainer(tmpdir, arch="yi-6b", steps=6, ckpt_every=3, lr=1e-3, **kw):
    cfg = registry.get_smoke_config(arch)
    tcfg = TrainerConfig(steps=steps, ckpt_every=ckpt_every, ckpt_dir=str(tmpdir),
                         log_every=100, **kw)
    return Trainer(cfg, TINY, topt.AdamWConfig(lr=lr, total_steps=steps), tcfg, device="cpu")


def test_trainer_runs_and_metrics_sane(tmp_path):
    tr = _trainer(tmp_path, steps=8, ckpt_every=0)
    log = tr.run()
    assert len(log) == 8
    losses = [m["loss"] for m in log]
    assert all(np.isfinite(losses))
    assert abs(losses[0] - np.log(tr.cfg.vocab)) < 1.0      # random tokens: ln V at init
    assert all(m["grad_norm"] > 0 for m in log)
    assert tr.params["layers"][0]["attn"]["w_q"].dtype == torch.bfloat16


def test_overfits_fixed_batch():
    """Stepping one batch drives the loss down (the gradient is right through
    remat, the chunked CE and the bf16 weights)."""
    cfg = registry.get_smoke_config("yi-6b")
    gen = torch.Generator().manual_seed(0)
    from repro_torch.models.transformer import init_params
    params = init_params(cfg, gen, "cpu")
    ocfg = topt.AdamWConfig(lr=3e-3, total_steps=30, warmup_steps=0)
    opt = topt.init_state(params, ocfg)
    step = tloop.make_train_step(cfg, ocfg, q_chunk=16, loss_chunk=16)
    batch = make_inputs(PipelineState(seed=0, step=0), cfg, TINY, device="cpu")
    losses = []
    for _ in range(25):
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 1.0, losses[:3] + losses[-3:]


def test_restore_resumes_the_uninterrupted_run_bit_for_bit(tmp_path):
    whole = _trainer(tmp_path / "a", steps=6, ckpt_every=3)
    whole.run()
    first = _trainer(tmp_path / "b", steps=6, ckpt_every=3)
    first.run(3)
    assert first.ckpt.latest_step() == 3
    resumed = _trainer(tmp_path / "b", steps=6, ckpt_every=3)
    assert resumed.try_restore()
    assert int(resumed.opt_state["step"]) == 3 and resumed.pipeline.step == 3
    log = resumed.run()
    assert [m["step"] for m in log] == [3, 4, 5]
    assert [m["loss"] for m in log] == [m["loss"] for m in whole.metrics_log[3:]]
    for a, b in zip(param_tensors([whole.params, whole.opt_state]),
                    param_tensors([resumed.params, resumed.opt_state])):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_written_mid_run_holds_its_own_step(tmp_path):
    """A checkpoint saved while the run goes on (async, the CPU tensors
    updated in place by the next steps) holds the state of its own step:
    step 3 of a 6-step run equals a 3-step run bit for bit."""
    whole = _trainer(tmp_path / "a", steps=6, ckpt_every=3)
    whole.run()
    short = _trainer(tmp_path / "b", steps=3, ckpt_every=0)
    short.run()
    trees = {"params": short.params, "opt": short.opt_state}
    out, meta = whole.ckpt.restore(trees, step=3)
    assert meta["step"] == 3 and meta["pipeline_step"] == 3
    for name, tree in trees.items():
        got, want = dict(M._leaves(out[name])), dict(M._leaves(tree))
        assert got.keys() == want.keys()
        for key, leaf in want.items():
            a, b = got[key], M.to_host(leaf)
            assert a.dtype == b.dtype and np.array_equal(a, b), (name, key)


def test_checkpoint_survives_partial_write(tmp_path):
    tr = _trainer(tmp_path, steps=3, ckpt_every=3)
    tr.run()
    os.makedirs(tmp_path / "step_99.tmp", exist_ok=True)
    (tmp_path / "step_99.tmp" / "params.npz").write_bytes(b"garbage")
    tr2 = _trainer(tmp_path, steps=3, ckpt_every=3)
    assert tr2.try_restore()
    assert int(tr2.opt_state["step"]) == 3


def test_checkpoint_keeps_last_k(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    tree = {"w": torch.ones(4, dtype=torch.bfloat16)}
    for s in (1, 2, 3, 4):
        mgr.save(s, {"params": tree})
    assert mgr.all_steps() == [3, 4]
    out, meta = mgr.restore({"params": tree})
    assert meta["step"] == 4 and out["params"]["w"].dtype == np.float32


def test_checkpoint_shape_mismatch_rejected(tmp_path):
    tr = _trainer(tmp_path, steps=3, ckpt_every=3)
    tr.run()
    other = Trainer(dataclasses.replace(tr.cfg, d_ff=2 * tr.cfg.d_ff), TINY,
                    tcfg=TrainerConfig(ckpt_dir=str(tmp_path)), device="cpu")
    with pytest.raises(ValueError, match="shape mismatch"):
        other.try_restore()


def test_bf16_optimizer_state_still_trains(tmp_path):
    cfg = registry.get_smoke_config("yi-6b")
    ocfg = topt.AdamWConfig(lr=1e-3, total_steps=8, state_dtype="bfloat16")
    tr = Trainer(cfg, TINY, ocfg, TrainerConfig(steps=6, ckpt_every=0, ckpt_dir=str(tmp_path)),
                 device="cpu")
    log = tr.run()
    assert log[-1]["loss"] < log[0]["loss"]
    assert param_tensors(tr.opt_state["mu"])[0].dtype == torch.bfloat16


def test_trainer_takes_no_mesh(tmp_path):
    """No mesh but a grid of ranks: anything else is refused (the grid's
    own cases are ``test_torch_train_parallel.py``'s and
    ``test_torch_train_elastic.py``'s)."""
    with pytest.raises(TypeError, match="GridMesh"):
        Trainer(registry.get_smoke_config("yi-6b"), TINY,
                tcfg=TrainerConfig(ckpt_dir=str(tmp_path)), device="cpu", mesh=object())


def test_expert_placement_refresh_counts_on_one_card(tmp_path):
    tr = _trainer(tmp_path, arch="granite-moe-1b-a400m", steps=2, ckpt_every=0,
                  rebalance_every=1)
    tr.run()
    batch = make_inputs(tr.pipeline, tr.cfg, TINY, device="cpu")
    counts = tr.refresh_expert_placement(batch)
    assert counts.sum() == 2 * 32 * tr.cfg.moe.top_k and tr.expert_assignment is None


# ---------------------------------------------------------------------------
# a reference checkpoint into the port
# ---------------------------------------------------------------------------


def test_reference_checkpoint_resumes_in_the_port(tmp_path):
    """The reference's Trainer, 2 steps of f32 Granite-MoE (its grouped
    layers; f32 AdamW state) checkpointed; the port's Trainer restores it
    and both take step 3 on the same batch."""
    from repro.train.loop import Trainer as JTrainer, TrainerConfig as JTrainerConfig
    jcfg, cfg = _f32(jreg, "granite-moe-1b-a400m"), _f32(registry, "granite-moe-1b-a400m")
    jtr = JTrainer(jcfg, TINY, jopt.AdamWConfig(lr=1e-3, total_steps=4),
                   JTrainerConfig(steps=2, ckpt_every=2, ckpt_dir=str(tmp_path)))
    jtr.run()
    tr = Trainer(cfg, TINY, topt.AdamWConfig(lr=1e-3, total_steps=4),
                 TrainerConfig(steps=3, ckpt_dir=str(tmp_path / "port")), device="cpu")
    assert tr.restore_reference(str(tmp_path))
    assert int(tr.opt_state["step"]) == 2 and tr.pipeline == PipelineState(0, 2)
    assert param_tensors(tr.opt_state["mu"])[0].dtype == torch.float32
    batch = _batch_np(cfg, B=2, T=32, seed=9)
    params, st, m = tr._step_fn(tr.params, tr.opt_state, _torch_batch(batch))
    pj, jst, jm = jtr._step_fn(jtr.params, jtr.opt_state,
                               {k: jnp.asarray(v) for k, v in batch.items()})
    for k in ("loss", "grad_norm", "lr"):
        assert abs(float(m[k]) - float(jm[k])) <= 1e-5 * abs(float(jm[k])), k
    # matched by leaf name: the converted tree orders its leaves otherwise
    # than the Trainer's own
    want = dict(flat_names(params_from_jax(jax.tree.map(np.asarray, pj), cfg, CPU)))
    for name, got in flat_names(params):
        assert _rel(got, want[name].numpy()) < 1e-5, name
    for key in ("mu", "nu"):
        want = dict(flat_names(params_from_jax(jax.tree.map(np.asarray, jst[key]), cfg,
                                               CPU, keep_dtype=True)))
        for name, got in flat_names(st[key]):
            assert _rel(got, want[name].numpy()) < 1e-4, name
    assert int(st["step"]) == 3
