"""Every LM family of the port against the reference on the CPU, whole
models at the smoke configs: logits, greedy tokens, the caches and
recurrent states after prefill and decode, the conversion of the
reference's grouped layers, a vlm's prefill with patch embeddings, and
the full-width parameter counts.

Weights come from the reference's ``init_params`` through
``convert.params_from_jax`` (zero-initialised biases drawn at random so
that they count); token ids and patch embeddings are made with numpy from
a seed.  Tolerances: f32 logits within 1e-4 rel L2 (three to five layers
of f32 sums in another order); f32 caches and states within 1e-5; the
bf16 KV caches and conv tails of an f32 model hold f32 values rounded to
bf16, where an f32 difference may flip a rounding: each element within
one bf16 ulp (2^-7 relative, or 1e-5 of the largest near zero), fewer
than 1% of them flipped; greedy tokens identical.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import registry as jreg
from repro.models import transformer as jt
from repro.serve import engine as je

from repro_torch.configs import registry
from repro_torch.models import transformer as tt
from repro_torch.models.convert import params_from_jax, scan_groups
from repro_torch.serve import engine as te

CPU = torch.device("cpu")
NEW_ARCHS = ["granite-moe-1b-a400m", "qwen3-moe-235b-a22b", "recurrentgemma-2b",
             "mamba2-1.3b", "musicgen-large", "internvl2-26b", "command-r-35b",
             "qwen1.5-32b"]
# biases and skips the reference initialises to zero or one
DRAWN = ("b_q", "b_k", "b_v", "lru_ba", "lru_bi", "conv_b", "dt_bias", "d_skip")


def _rel(a, b):
    a = a.detach().to(torch.float32).numpy() if torch.is_tensor(a) else np.asarray(a, np.float32)
    b = np.asarray(jnp.asarray(b, jnp.float32))
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _draw(tree, rng):
    for k, v in tree.items():
        if isinstance(v, dict):
            _draw(v, rng)
        elif isinstance(v, list):
            for item in v:
                _draw(item, rng)
        elif k in DRAWN:
            tree[k] = rng.normal(scale=0.3, size=v.shape).astype(np.float32)


def _models(arch, dtype="float32", layers=None, seed=0):
    """(port cfg, reference cfg, port params, reference params)."""
    tcfg = dataclasses.replace(registry.get_smoke_config(arch), dtype=dtype)
    jcfg = dataclasses.replace(jreg.get_smoke_config(arch), dtype=dtype)
    if layers is not None:
        tcfg = dataclasses.replace(tcfg, num_layers=layers)
        jcfg = dataclasses.replace(jcfg, num_layers=layers)
    pnp = jax.tree.map(np.asarray, jt.init_params(jax.random.PRNGKey(seed), jcfg))
    for group in pnp["groups"]:
        for tree in group:
            _draw(tree, np.random.default_rng(seed))
    return tcfg, jcfg, params_from_jax(pnp, tcfg, CPU), jax.tree.map(jnp.asarray, pnp)


def _patches(cfg, B, seed=5):
    if not cfg.num_patches:
        return None
    return np.random.default_rng(seed).normal(
        size=(B, cfg.num_patches, cfg.patch_dim)).astype(np.float32)


def _ref_layers(groups, kinds):
    """The reference's grouped caches (or params), one tree per layer."""
    out = []
    for (pat, reps), g in zip(jt._scan_groups(kinds), groups):
        for r in range(reps):
            out += [g[j] if reps == 1 else jax.tree.map(lambda x: x[r], g[j])
                    for j in range(len(pat))]
    return out


def _same_tree(got, want, tol):
    assert sorted(got) == sorted(want)
    for k in got:
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype), k
        if got[k].dtype in (torch.int32, torch.int64):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        elif got[k].dtype == torch.bfloat16:
            # f32 values stored in bf16: an f32 difference may flip one
            # rounding, one bf16 ulp (at most 2^-7 relative) on an element
            w = torch.tensor(np.asarray(jnp.asarray(want[k], jnp.float32)))
            torch.testing.assert_close(got[k].float(), w, rtol=2 ** -7,
                                       atol=tol * float(w.abs().max()))
            assert float((got[k].float() != w).float().mean()) < 0.01, k
        else:
            assert _rel(got[k], want[k]) < tol, k


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_forward_matches_reference(arch):
    cfg, jcfg, pt, pj = _models(arch)
    tokens = np.random.default_rng(7).integers(0, cfg.vocab, (2, 40)).astype(np.int32)
    pe = _patches(cfg, 2)
    jh, _ = jax.jit(lambda p, t, e: jt.forward(p, t, jcfg, None, patch_embeds=e,
                                               q_chunk=16))(pj, jnp.asarray(tokens),
                                                            None if pe is None else jnp.asarray(pe))
    th, _ = tt.forward(pt, torch.tensor(tokens, dtype=torch.long), cfg, q_chunk=16,
                       patch_embeds=None if pe is None else torch.tensor(pe))
    T = 40 + (cfg.num_patches if pe is not None else 0)
    got = tt.unembed(pt, th, cfg)
    assert got.shape == (2, T, cfg.vocab)
    assert _rel(got, jt.unembed(pj, jh, jcfg)) < 1e-4


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_greedy_tokens_match_reference(arch):
    cfg, jcfg, pt, pj = _models(arch, seed=1)
    prompts = np.random.default_rng(8).integers(0, cfg.vocab, (2, 40)).astype(np.int32)
    want = je.ServeEngine(pj, jcfg, batch_slots=2, max_len=48).step_all(prompts, 4)
    got = te.ServeEngine(pt, cfg, batch_slots=2, max_len=48, device="cpu").step_all(prompts, 4)
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "recurrentgemma-2b",
                                  "mamba2-1.3b", "internvl2-26b"])
def test_caches_after_prefill_and_decode_match_reference(arch):
    """Every layer's cache after a prefill of 40 positions and two decode
    steps: the hybrid's ring buffer of min(48, window 32) slots wraps in
    both, the conv tails come back f32 from the bf16 buffers, as the
    reference's do."""
    cfg, jcfg, pt, pj = _models(arch, seed=2)
    B, T = 2, 40 - cfg.num_patches
    tokens = np.random.default_rng(9).integers(0, cfg.vocab, (B, T)).astype(np.int32)
    pe = _patches(cfg, B)
    P = 0 if pe is None else cfg.num_patches
    jpre, jdec = je.make_serve_fns(jcfg, q_chunk=16)
    tpre, tdec = te.make_serve_fns(cfg, q_chunk=16)
    jl, jc = jpre(pj, jnp.asarray(tokens), jt.init_cache(jcfg, B, 48),
                  patch_embeds=None if pe is None else jnp.asarray(pe))
    tl_, tc = tpre(pt, torch.tensor(tokens).long(), tt.init_cache(cfg, B, 48, device=CPU),
                   patch_embeds=None if pe is None else torch.tensor(pe))
    kinds = tt.layer_kinds(cfg)
    for step in range(3):
        assert _rel(tl_, jl) < 1e-4
        for got, want in zip(tc, _ref_layers(jc, kinds)):
            _same_tree(got, want, 1e-5)
        if step == 2:
            break
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
        np.testing.assert_array_equal(tl_.argmax(-1).numpy(), tok[:, 0])
        jl, jc = jdec(pj, jnp.asarray(tok), jnp.int32(P + T + step), jc)
        tl_, tc = tdec(pt, torch.tensor(tok).long(), P + T + step, tc)
    if cfg.rglru is not None:
        pos = [c["pos"] for c, k in zip(tc, kinds) if k == "attn"][0]
        assert pos.shape == (cfg.rglru.window,) and int(pos.max()) == P + T + 1


def test_vlm_prefill_step_with_patches_matches_reference():
    cfg, jcfg, pt, pj = _models("internvl2-26b", seed=3)
    tokens = np.random.default_rng(10).integers(0, cfg.vocab, (2, 12)).astype(np.int32)
    pe = _patches(cfg, 2, seed=11)
    jl, _ = je.prefill_step(pj, jnp.asarray(tokens), jt.init_cache(jcfg, 2, 40), jcfg,
                            patch_embeds=jnp.asarray(pe), q_chunk=16)
    tl_, tc = te.prefill_step(pt, torch.tensor(tokens).long(),
                              tt.init_cache(cfg, 2, 40, device=CPU), cfg,
                              patch_embeds=torch.tensor(pe), q_chunk=16)
    assert _rel(tl_, jl) < 1e-4
    assert int(tc[0]["pos"].max()) == cfg.num_patches + 12 - 1
    # without patches the vlm reads text alone, as the reference's does
    tl2, _ = te.prefill_step(pt, torch.tensor(tokens).long(),
                             tt.init_cache(cfg, 2, 40, device=CPU), cfg, q_chunk=16)
    assert _rel(tl2, tl_) > 1e-3


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "mamba2-1.3b"])
def test_bf16_model_matches_reference(arch):
    cfg, jcfg, pt, pj = _models(arch, "bfloat16", seed=4)
    tokens = np.random.default_rng(12).integers(0, cfg.vocab, (2, 40)).astype(np.int32)
    jh, _ = jax.jit(lambda p, t: jt.forward(p, t, jcfg, None, q_chunk=16))(
        pj, jnp.asarray(tokens))
    th, _ = tt.forward(pt, torch.tensor(tokens).long(), cfg, q_chunk=16)
    assert th.dtype == torch.bfloat16
    assert _rel(tt.unembed(pt, th, cfg), jt.unembed(pj, jh, jcfg)) < 3e-2


# ---------------------------------------------------------------------------
# the reference's grouped layout, stored dtypes, parameter counts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kinds", [
    ["attn"] * 5, ["mamba"], ["rglru", "rglru", "attn"] * 8 + ["rglru"] * 2,
    ["rglru", "rglru", "attn", "rglru", "rglru"],
    ["rglru", "rglru", "attn"] * 2 + ["rglru", "rglru"], ["a", "b", "c"]])
def test_scan_groups_is_the_reference_grouping(kinds):
    assert scan_groups(kinds) == jt._scan_groups(kinds)


@pytest.mark.parametrize("layers,groups", [
    (8, [(["rglru", "rglru", "attn"], 2), (["rglru"], 1), (["rglru"], 1)]),
    (5, [(["rglru"], 1), (["rglru"], 1), (["attn"], 1), (["rglru"], 1), (["rglru"], 1)])])
def test_convert_reads_grouped_layers(layers, groups):
    """recurrentgemma at 8 layers (a group with reps = 2 and two single
    layers) and at its 5-layer smoke config (five single groups): layer i
    of the port holds the reference's layer i, in the dtype it is read."""
    cfg, jcfg, pt, pj = _models("recurrentgemma-2b", "bfloat16", layers=layers, seed=5)
    kinds = jt.layer_kinds(jcfg)
    assert jt._scan_groups(kinds) == groups
    want = _ref_layers(pj["groups"], kinds)
    assert len(pt["layers"]) == len(want) == layers
    for i, (got, ref) in enumerate(zip(pt["layers"], want)):
        assert ("rec" in got) == (kinds[i] == "rglru")
        for name, leaf in jax.tree_util.tree_flatten_with_path(ref)[0]:
            keys = [k.key for k in name]
            t = got
            for k in keys:
                t = t[k]
            f32 = keys[-1] in tt.F32_WEIGHTS
            assert t.dtype == (torch.float32 if f32 else torch.bfloat16)
            np.testing.assert_array_equal(
                t.to(torch.float32).numpy(),
                np.asarray(jnp.asarray(leaf, jnp.float32 if f32 else jnp.bfloat16),
                           np.float32))


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_init_params_has_the_reference_layout(arch):
    """The port's random parameters: the reference's shapes layer by layer,
    each stored in the dtype in which forward reads it."""
    cfg = registry.get_smoke_config(arch)
    pt = tt.init_params(cfg, torch.Generator().manual_seed(0), CPU)
    pj = jt.init_params(jax.random.PRNGKey(0), jreg.get_smoke_config(arch))
    want = _ref_layers(pj["groups"], jt.layer_kinds(jreg.get_smoke_config(arch)))
    shapes = jax.tree.map(lambda x: tuple(x.shape), want)
    assert jax.tree.map(lambda t: tuple(t.shape), pt["layers"]) == shapes
    for layer in pt["layers"]:
        for name, t in jax.tree_util.tree_flatten_with_path(layer)[0]:
            f32 = name[-1].key in tt.F32_WEIGHTS
            assert t.dtype == (torch.float32 if f32 else getattr(torch, cfg.dtype))
    top = {k for k in pj if k != "groups"}
    assert set(pt) - {"layers"} == top
