"""Serving on a grid of ranks (``serve/engine.py`` with ``mesh=``,
``serve/grid.py``) against the one-rank port and the reference, on the CPU.

One ``spawn_world`` of 4 gloo ranks as a ``(2, 2)`` ``(data, model)`` grid
serves four smoke configs in f32, each from the reference's weights
(``convert.params_from_jax``, zero-initialised biases drawn at random):

* dense Yi-6B (2 KV heads: the caches split by heads over ``model``);
* MoE granite-moe-1b-a400m (2 KV heads; the experts on their model rank;
  capacity factor ``E / k``, so that nothing drops: the reference routes a
  data shard's rows on a grid and all rows on one device, which drop
  differently);
* the hybrid recurrentgemma-2b (1 KV head: the caches split by sequence;
  its local attention's ring buffer of 32 slots under a prompt of 40);
* the SSM mamba2-1.3b (its states split by heads and channels).

Batch 4 (2 rows a data rank), prompts of 40 tokens, ``max_len`` 48.  On
every rank: the prefill logits within 1e-5 rel L2 of the one-rank port's
and of the reference's ``prefill_step``, and the greedy tokens of
``ServeEngine.step_all`` (4 new) equal to both; every cache leaf, after
prefill and after two decode steps, is the matching block of the one-rank
cache (bf16 KV caches and conv tails hold f32 values rounded to bf16, where
an f32 difference may flip a rounding: each element within one bf16 ulp,
fewer than 1% flipped; f32 states within 1e-5); the four ranks' schedules
verify.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.analysis.schedule import verify_schedules
from repro_torch.configs import registry
from repro_torch.launch.mesh import make_grid_mesh, spawn_world
from repro_torch.models import transformer as tt
from repro_torch.models.convert import params_from_jax
from repro_torch.parallel import sharding as shd
from repro_torch.serve import engine as te
from repro_torch.serve import grid as sg

CPU = torch.device("cpu")
ARCHS = ["yi-6b", "granite-moe-1b-a400m", "recurrentgemma-2b", "mamba2-1.3b"]
LAYOUT = {"yi-6b": "heads", "granite-moe-1b-a400m": "heads",
          "recurrentgemma-2b": "sequence", "mamba2-1.3b": "heads"}
B, T, MAX_LEN, NEW, DECODES = 4, 40, 48, 4, 2
DRAWN = ("b_q", "b_k", "b_v", "lru_ba", "lru_bi", "conv_b", "dt_bias", "d_skip")


def _cfgs(arch, reference: bool = False):
    """The port's config (and with ``reference`` the reference's); jax is
    imported only where the reference runs, not in the ranks."""
    regs = [registry]
    if reference:
        from repro.configs import registry as jreg
        regs.append(jreg)
    out = []
    for reg in regs:
        cfg = dataclasses.replace(reg.get_smoke_config(arch), dtype="float32")
        if cfg.moe is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
        out.append(cfg)
    return out


def _draw(tree, rng):
    for k, v in tree.items():
        if isinstance(v, dict):
            _draw(v, rng)
        elif isinstance(v, list):
            for item in v:
                _draw(item, rng)
        elif k in DRAWN:
            tree[k] = rng.normal(scale=0.3, size=v.shape).astype(np.float32)


def _weights(arch, jcfg):
    import jax
    from repro.models import transformer as jt
    pnp = jax.tree.map(np.asarray, jt.init_params(jax.random.PRNGKey(2), jcfg))
    for group in pnp["groups"]:
        for tree in group:
            _draw(tree, np.random.default_rng(3))
    return pnp


def _prompts(cfg):
    return np.random.default_rng(7).integers(0, cfg.vocab, (B, T)).astype(np.int32)


def _serve(params, cfg, mesh=None):
    """(prefill logits, caches after prefill, caches after DECODES decode
    steps, step_all's tokens); caches as lists of host tensors."""
    eng = te.ServeEngine(params, cfg, batch_slots=B, max_len=MAX_LEN, device=CPU, mesh=mesh)
    tokens = torch.as_tensor(_prompts(cfg)).long()
    caches = eng.init_cache(B)
    logits, caches = eng.prefill_fn(params, tokens, caches)
    after = [t.clone() for t in tt.param_tensors(caches)]
    tok = logits.argmax(-1)
    for i in range(DECODES):
        _, caches = eng.decode_fn(params, tok[:, None], T + i, caches)
    decoded = [t.clone() for t in tt.param_tensors(caches)]
    return logits, after, decoded, eng.step_all(_prompts(cfg), NEW)


def _rank(world, weights):
    grid = make_grid_mesh((2, 2), ("data", "model"), device="cpu")
    out = {"coords": grid.coords, "runs": {}}
    for arch in ARCHS:
        cfg, = _cfgs(arch)
        full = params_from_jax(weights[arch], cfg, CPU)
        blocks = sg.param_blocks(full, cfg, grid)
        out["runs"][arch] = _serve(blocks, cfg, grid)
    out["log"] = list(grid.log.events)
    return out


@pytest.fixture(scope="module")
def runs():
    import jax
    import jax.numpy as jnp
    from repro.models import transformer as jt
    from repro.serve import engine as je
    weights, want = {}, {}
    for arch in ARCHS:
        cfg, jcfg = _cfgs(arch, reference=True)
        pnp = weights[arch] = _weights(arch, jcfg)
        pj = jax.tree.map(jnp.asarray, pnp)
        prompts = _prompts(cfg)
        eng = je.ServeEngine(pj, jcfg, batch_slots=B, max_len=MAX_LEN)
        ref_logits, _ = eng.prefill_fn(pj, jnp.asarray(prompts), jt.init_cache(jcfg, B, MAX_LEN))
        ref_tokens = eng.step_all(prompts, NEW)
        full = params_from_jax(pnp, cfg, CPU)
        want[arch] = {"ref_logits": np.asarray(ref_logits), "ref_tokens": np.asarray(ref_tokens),
                      "one": _serve(full, cfg),
                      "specs": sg.cache_specs(shd.AbstractGrid((2, 2), ("data", "model")),
                                              tt.init_cache(cfg, B, MAX_LEN, device="meta"))}
    ranks = spawn_world(_rank, 4, device="cpu", timeout_s=300, args=(weights,))
    return want, ranks


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _cache_close(got: torch.Tensor, want: torch.Tensor, name: str) -> None:
    assert got.shape == want.shape and got.dtype == want.dtype, name
    if want.dtype == torch.int32:
        assert torch.equal(got, want), name
        return
    g, w = got.double(), want.double()
    if want.dtype == torch.bfloat16:
        ulp = 2.0 ** -7 * w.abs() + 1e-5 * float(w.abs().max())
        flipped = float(((g - w).abs() > 0).double().mean())
        assert bool(((g - w).abs() <= ulp).all()) and flipped < 0.01, (name, flipped)
    else:
        assert _rel(g, w) < 1e-5, name


@pytest.mark.parametrize("arch", ARCHS)
def test_grid_logits_and_tokens_match_one_rank_and_reference(arch, runs):
    want, ranks = runs
    w = want[arch]
    one_logits, _, _, one_tokens = w["one"]
    assert _rel(one_logits, w["ref_logits"]) < 1e-5
    np.testing.assert_array_equal(one_tokens, w["ref_tokens"])
    for rk in ranks:
        logits, _, _, tokens = rk["runs"][arch]
        assert logits.shape == (B, registry.get_smoke_config(arch).vocab)
        assert _rel(logits, one_logits) < 1e-5, rk["coords"]
        assert _rel(logits, w["ref_logits"]) < 1e-5, rk["coords"]
        np.testing.assert_array_equal(tokens, one_tokens)
        np.testing.assert_array_equal(tokens, w["ref_tokens"])


@pytest.mark.parametrize("stage", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_grid_cache_blocks_are_blocks_of_the_one_rank_cache(arch, stage, runs):
    want, ranks = runs
    w = want[arch]
    k = 1 if stage == "prefill" else 2
    full = w["one"][k]
    names = [n for n, _ in shd.flat_names(tt.init_cache(_cfgs(arch)[0], B, MAX_LEN,
                                                        device="meta"))]
    for rk in ranks:
        blocks = rk["runs"][arch][k]
        probe = shd.AbstractGrid((2, 2), ("data", "model"))
        for name, got, whole, spec in zip(names, blocks, full, w["specs"]):
            # this rank's block: the spec's axes at this rank's coordinates
            sl = whole
            for d, entry in enumerate(spec):
                axes = shd.spec_axes(entry)
                n = shd.axis_size(probe, axes or None)
                if n > 1:
                    idx = 0
                    for a in axes:
                        idx = idx * 2 + rk["coords"][("data", "model").index(a)]
                    size = sl.shape[d] // n
                    sl = sl.narrow(d, idx * size, size)
            assert tuple(got.shape) == tuple(sl.shape), (name, spec)
            _cache_close(got, sl, f"{arch} {stage} {name} {rk['coords']}")


@pytest.mark.parametrize("arch", ARCHS)
def test_grid_caches_take_the_reference_layout(arch, runs):
    """The KV caches split by heads where the KV heads divide the model
    axis, else by sequence (``kv_cache_spec``); the schedules verify."""
    want, ranks = runs
    cfg = _cfgs(arch)[0]
    probe = shd.AbstractGrid((2, 2), ("data", "model"))
    assert sg.kv_layout(cfg, probe) == ("heads" if cfg.num_kv_heads % 2 == 0 else "sequence")
    if cfg.family != "ssm":
        assert sg.kv_layout(cfg, probe) == LAYOUT[arch]
        kv = [s for n, s in zip([n for n, _ in shd.flat_names(
            tt.init_cache(cfg, B, MAX_LEN, device="meta"))], want[arch]["specs"])
            if n.endswith("/k")]
        dim = 1 if LAYOUT[arch] == "heads" else 2
        assert all(s[dim] == "model" and s[0] == ("data",) for s in kv), kv
    assert verify_schedules([rk["log"] for rk in ranks]).ok


def test_route_takes_given_choices():
    """``moe.route(choices=)`` routes each token to the given experts with the
    softmax of its logits at them: its own top-k give its own routing bit
    for bit, and other choices land where they say (the card's grid gate
    holds a one-rank engine routed as the grid routed)."""
    from repro_torch.models import moe
    g = torch.Generator().manual_seed(3)
    x, router = torch.randn(10, 16, generator=g), torch.randn(16, 6, generator=g)
    own = moe.route(x, router, top_k=2, capacity=10)
    top = torch.topk(x @ router, 2, dim=-1).indices
    same = moe.route(x, router, top_k=2, capacity=10, choices=top)
    for a, b in zip(own, same):
        assert torch.equal(a, b)
    other = torch.stack([top[:, 1], (top[:, 0] + 1) % 6], dim=1)
    flat_e, flat_w, _, keep = moe.route(x, router, top_k=2, capacity=10, choices=other)
    assert torch.equal(flat_e, other.reshape(-1)) and bool(keep.all())
    want = torch.softmax(torch.gather(x @ router, 1, other), dim=-1).reshape(-1)
    assert torch.allclose(flat_w, want)
