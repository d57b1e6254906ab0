"""The port's dense-LM serving path against the reference on the CPU.

Weights come from the reference's ``init_params`` and cross through
``convert.params_from_jax``; token ids and activations are made with numpy
from a seed and fed to both packages.

Tolerances: f32 layers within 1e-5 rel L2 (same arithmetic, f32 sums in
another order; rope 1e-5 for f32 sin/cos of another library); attention
within 2e-5, as the reference holds its own kernel; whole-model f32 logits
within 1e-4 (three layers of such differences); bf16 logits within 3e-2
(bf16 rounds at other places in the two frameworks, about 4e-3 per
rounding, compounded over three layers); greedy tokens in f32 identical.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import codeqwen15_7b as j_codeqwen
from repro.configs import yi_6b as j_yi
from repro.models import layers as jl
from repro.models import transformer as jt
from repro.serve.engine import ServeEngine as JServeEngine

from repro_torch.configs import registry
from repro_torch.configs.codeqwen15_7b import SMOKE_CONFIG as CODEQWEN_SMOKE
from repro_torch.configs.yi_6b import SMOKE_CONFIG as YI_SMOKE
from repro_torch.models import layers as tl
from repro_torch.models import transformer as tt
from repro_torch.models.convert import params_from_jax
from repro_torch.serve.engine import ServeEngine, make_serve_fns

CPU = torch.device("cpu")
SMOKES = {"yi_6b": (YI_SMOKE, j_yi.SMOKE_CONFIG),
          "codeqwen15_7b": (CODEQWEN_SMOKE, j_codeqwen.SMOKE_CONFIG)}


def _rel(a, b):
    a = a.detach().to(torch.float32).numpy() if torch.is_tensor(a) else np.asarray(a, np.float32)
    b = b.detach().to(torch.float32).numpy() if torch.is_tensor(b) else np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _both(a, dtype="float32"):
    """One numpy array as a jax array and a torch tensor of the same dtype."""
    return jnp.asarray(a, dtype), torch.tensor(np.asarray(a, np.float32)).to(getattr(torch, dtype))


def _models(arch, dtype, seed=0):
    """(port cfg, reference cfg, port params, reference params).  QKV biases,
    zero at init, are drawn at random so that they count."""
    tcfg, jcfg = SMOKES[arch]
    tcfg = dataclasses.replace(tcfg, dtype=dtype)
    jcfg = dataclasses.replace(jcfg, dtype=dtype)
    pnp = jax.tree.map(np.asarray, jt.init_params(jax.random.PRNGKey(seed), jcfg))
    if jcfg.qkv_bias:
        rng = np.random.default_rng(seed)
        attn = pnp["groups"][0][0]["attn"]
        for name in ("b_q", "b_k", "b_v"):
            attn[name] = rng.normal(scale=0.5, size=attn[name].shape).astype(np.float32)
    return tcfg, jcfg, params_from_jax(pnp, tcfg, CPU), jax.tree.map(jnp.asarray, pnp)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-6), ("bfloat16", 1e-2)])
def test_rms_norm(dtype, tol):
    rng = np.random.default_rng(0)
    jx, tx = _both(rng.normal(size=(2, 5, 64)) * 3, dtype)
    js, ts = _both(rng.normal(size=(64,)), dtype)
    assert _rel(tl.rms_norm(tx, ts, 1e-6), jl.rms_norm(jx, js, 1e-6)) < tol


@pytest.mark.parametrize("batched_pos", [False, True])
def test_rope(batched_pos):
    rng = np.random.default_rng(1)
    jx, tx = _both(rng.normal(size=(2, 7, 4, 32)))
    pos = rng.integers(0, 500, size=(2, 7) if batched_pos else (7,)).astype(np.int32)
    got = tl.rope(tx, torch.tensor(pos), 10_000.0)
    assert _rel(got, jl.rope(jx, jnp.asarray(pos), 10_000.0)) < 1e-5


@pytest.mark.parametrize("q_chunk", [16, 512])          # chunked, unchunked
@pytest.mark.parametrize("window,q_offset", [(None, 0), (None, 24), (12, 0)])
def test_attention_core(q_chunk, window, q_offset):
    rng = np.random.default_rng(2)
    T, S = 48, 48 + q_offset
    jq, tq = _both(rng.normal(size=(2, 8, T, 16)))
    jk, tk = _both(rng.normal(size=(2, 2, S, 16)))
    jv, tv = _both(rng.normal(size=(2, 2, S, 16)))
    want = jl.attention_core(jq, jk, jv, causal=True, window=window,
                             q_chunk=q_chunk, q_offset=q_offset)
    got = tl.attention_core(tq, tk, tv, causal=True, window=window,
                            q_chunk=q_chunk, q_offset=q_offset)
    assert _rel(got, want) < 2e-5


def test_attention_core_bf16_scores():
    rng = np.random.default_rng(3)
    jq, tq = _both(rng.normal(size=(1, 4, 32, 16)), "bfloat16")
    jk, tk = _both(rng.normal(size=(1, 4, 32, 16)), "bfloat16")
    jv, tv = _both(rng.normal(size=(1, 4, 32, 16)), "bfloat16")
    want = jl.attention_core(jq, jk, jv, q_chunk=16, score_dtype=jnp.bfloat16)
    got = tl.attention_core(tq, tk, tv, q_chunk=16, score_dtype=torch.bfloat16)
    assert _rel(got, want.astype(jnp.float32)) < 2e-2


def test_attention_core_refuses_the_dry_run_probe():
    """The dry run's accounting stand-in (``impl="skip_core"``) was refused
    until the port's dry run needed it; it is now the reference's stand-in
    (GQA, 4 query heads on 2 kv heads), and an unknown impl is refused."""
    rng = np.random.default_rng(5)
    jq, tq = _both(rng.normal(size=(2, 4, 8, 16)))
    jk, tk = _both(rng.normal(size=(2, 2, 8, 16)))
    jv, tv = _both(rng.normal(size=(2, 2, 8, 16)))
    want = jl.attention_core(jq, jk, jv, impl="skip_core")
    got = tl.attention_core(tq, tk, tv, impl="skip_core")
    assert got.shape == tq.shape and _rel(got, want) < 1e-6
    with pytest.raises(ValueError, match="unknown attention impl"):
        tl.attention_core(tq, tk, tv, impl="flash")


@pytest.mark.parametrize("window", [None, 8])
def test_decode_attention(window):
    rng = np.random.default_rng(4)
    jq, tq = _both(rng.normal(size=(2, 8, 1, 16)))
    jk, tk = _both(rng.normal(size=(2, 2, 40, 16)))
    jv, tv = _both(rng.normal(size=(2, 2, 40, 16)))
    want = jl.decode_attention(jq, jk, jv, jnp.int32(29), window=window)
    got = tl.decode_attention(tq, tk, tv, 29, window=window)
    assert _rel(got, want) < 2e-5


def test_mlp_layer():
    rng = np.random.default_rng(5)
    pj = jl.init_mlp(jax.random.PRNGKey(5), 64, 96)
    pt = {k: torch.tensor(np.asarray(v)) for k, v in pj.items()}
    jx, tx = _both(rng.normal(size=(2, 5, 64)))
    assert _rel(tl.mlp_layer(pt, tx), jl.mlp_layer(pj, jx)) < 1e-5


@pytest.mark.parametrize("decode", [False, True])
def test_attention_layer_with_cache(decode):
    cfg, jcfg, _, _ = _models("codeqwen15_7b", "float32")
    pj = jl.init_attention(jax.random.PRNGKey(6), jcfg)
    pj = dict(pj, b_q=pj["b_q"] + 0.3, b_v=pj["b_v"] - 0.2)
    pt = {k: torch.tensor(np.asarray(v)) for k, v in pj.items()}
    rng = np.random.default_rng(6)
    T, S = (1, 24) if decode else (12, 24)
    jx, tx = _both(rng.normal(size=(2, T, cfg.d_model)))
    shape = (2, cfg.num_kv_heads, S, cfg.head_dim_)
    jck, tck = _both(rng.normal(size=shape))
    jcv, tcv = _both(rng.normal(size=shape))
    idx = 17 if decode else None
    pos = np.full((2, 1), 17, np.int32) if decode else np.arange(T, dtype=np.int32)
    jout, (jk, jv) = jl.attention_layer(pj, jx, jcfg, positions=jnp.asarray(pos),
                                        cache=(jck, jcv),
                                        cache_index=None if idx is None else jnp.int32(idx))
    tout, (tk, tv) = tl.attention_layer(pt, tx, cfg, positions=torch.tensor(pos),
                                        cache=(tck, tcv), cache_index=idx)
    assert _rel(tout, jout) < 2e-5
    assert _rel(tk, jk) < 1e-5 and _rel(tv, jv) < 1e-5


# ---------------------------------------------------------------------------
# whole model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", sorted(SMOKES))
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 3e-2)])
def test_forward_unembed_matches_reference(arch, dtype, tol):
    cfg, jcfg, pt, pj = _models(arch, dtype)
    tokens = np.random.default_rng(7).integers(0, cfg.vocab, (2, 40)).astype(np.int32)
    jh, _ = jax.jit(lambda p, t: jt.forward(p, t, jcfg, None, q_chunk=16))(pj, jnp.asarray(tokens))
    want = jt.unembed(pj, jh, jcfg)
    th, _ = tt.forward(pt, torch.tensor(tokens, dtype=torch.long), cfg, q_chunk=16)
    got = tt.unembed(pt, th, cfg)
    assert th.dtype == getattr(torch, dtype) and got.shape == (2, 40, cfg.vocab)
    assert _rel(got, want) < tol


@pytest.mark.parametrize("arch", sorted(SMOKES))
def test_serve_engine_matches_reference_tokens(arch):
    cfg, jcfg, pt, pj = _models(arch, "float32", seed=1)
    prompts = np.random.default_rng(8).integers(0, cfg.vocab, (2, 32)).astype(np.int32)
    want = JServeEngine(pj, jcfg, batch_slots=2, max_len=48).step_all(prompts, 8)
    got = ServeEngine(pt, cfg, batch_slots=2, max_len=48, device="cpu").step_all(prompts, 8)
    assert got.dtype == np.int32 and got.shape == (2, 8)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_serve_prefill_decode_consistent_with_teacher_forcing():
    """The reference's own check (tests/test_archs.py) on the port: greedy
    decode after prefill agrees with a teacher-forced forward."""
    cfg = YI_SMOKE
    params = tt.init_params(cfg, torch.Generator().manual_seed(0), CPU)
    B, T_prompt, n_new = 2, 32, 4
    prompt = torch.tensor(np.random.default_rng(0).integers(0, cfg.vocab, (B, T_prompt)))
    caches = tt.init_cache(cfg, B, max_len=64, device=CPU)
    pre, dec = make_serve_fns(cfg, q_chunk=16)
    logits, caches = pre(params, prompt, caches)
    assert logits.shape == (B, cfg.vocab)
    toks = [logits.argmax(-1)]
    for t in range(n_new):
        logits, caches = dec(params, toks[-1][:, None], T_prompt + t, caches)
        assert bool(torch.isfinite(logits).all())
        toks.append(logits.argmax(-1))
    full = torch.cat([prompt] + [t[:, None] for t in toks[:-1]], dim=1)
    h, _ = tt.forward(params, full, cfg, q_chunk=16)
    ref_next = tt.unembed(params, h[:, -1:], cfg)[:, 0].argmax(-1)
    torch.testing.assert_close(ref_next, toks[-1], rtol=0, atol=0)


def test_engine_refuses_a_prompt_past_max_len():
    params = tt.init_params(YI_SMOKE, device=CPU)
    engine = ServeEngine(params, YI_SMOKE, batch_slots=1, max_len=16, device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        engine.step_all(np.zeros((1, 12), np.int32), 5)


# ---------------------------------------------------------------------------
# parameters, configs, families
# ---------------------------------------------------------------------------


# the reference's own init_params, counted by jax.eval_shape; cfg.param_count
# is analytic and crude for two families (every hybrid layer counted as
# attention + MLP; Mamba-2's d_skip and conv_b left out)
PARAM_COUNTS = {"recurrentgemma-2b": (3_549_888_000, 3_219_264_000),
                "mamba2-1.3b": (1_446_714_368, 1_446_502_400)}


LM_ARCHS = ["qwen3-moe-235b-a22b", "granite-moe-1b-a400m", "command-r-35b",
            "codeqwen1.5-7b", "yi-6b", "qwen1.5-32b", "recurrentgemma-2b",
            "musicgen-large", "internvl2-26b", "mamba2-1.3b"]


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_full_width_param_count(arch):
    """Full-width parameters on the meta device (no memory is touched)
    against the reference's ``init_params`` under ``jax.eval_shape``."""
    cfg = registry.get_config(arch)
    params = tt.init_params(cfg, torch.Generator(), "meta")
    n = sum(t.numel() for t in tt.param_tensors(params))
    from repro.configs.registry import get_config as jget
    shapes = jax.eval_shape(lambda k: jt.init_params(k, jget(arch)), jax.random.PRNGKey(0))
    assert n == sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    real, analytic = PARAM_COUNTS.get(arch, (n, n))
    assert (n, cfg.param_count) == (real, analytic)
    if arch == "yi-6b":
        assert n == 6_061_035_520


def test_converted_params_are_stored_as_forward_reads_them():
    cfg, _, pt, _ = _models("yi_6b", "bfloat16")
    assert pt["lm_head"].dtype == torch.float32
    assert pt["embed"].dtype == torch.bfloat16
    assert len(pt["layers"]) == cfg.num_layers
    assert {t.dtype for t in tt.param_tensors(pt["layers"])} == {torch.bfloat16}
    tied = dataclasses.replace(cfg, tie_embeddings=True)
    assert tt.init_params(tied, device=CPU)["embed"].dtype == torch.float32


def test_configs_are_the_reference_configs():
    from repro.configs.registry import get_config as jget
    from repro.configs.registry import get_smoke_config as jsmoke
    for tcfg, jcfg in SMOKES.values():
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    from repro.configs.registry import ARCHS as J_ARCHS
    assert registry.ARCHS == J_ARCHS
    assert [registry.canonical(a) for a in LM_ARCHS] == registry.lm_archs()
    for arch in LM_ARCHS:
        assert dataclasses.asdict(registry.get_config(arch)) == dataclasses.asdict(jget(arch))
        assert (dataclasses.asdict(registry.get_smoke_config(arch))
                == dataclasses.asdict(jsmoke(arch)))
    assert registry.get_config("petfmm-vortex").p == 17


@pytest.mark.parametrize("arch", ["gpt-2", "yi_7b", "mamba"])
def test_unknown_arch_raises_key_error(arch):
    with pytest.raises(KeyError, match="unknown arch"):
        registry.get_config(arch)
