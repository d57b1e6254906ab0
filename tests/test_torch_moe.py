"""The port's MoE layer (``models/moe.py``) against the reference's on the
CPU: routing, capacity and drops, the experts' output, and the cost-model
expert placement.

Weights come from the reference's ``init_moe``; activations are made with
numpy from a seed.  Tolerances: f32 within 1e-5 rel L2 (the same
arithmetic, f32 sums in another order: the port combines a token's k
contributions by a fixed-order sum where the reference scatter-adds);
bf16 within 3e-2 (bf16 rounds at other places in the two frameworks,
about 4e-3 a rounding).  Routing is compared exactly: the inputs are
continuous random values, so no two logits tie.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import granite_moe_1b_a400m as j_granite
from repro.configs import qwen3_moe_235b_a22b as j_qwen3
from repro.models import moe as jm

from repro_torch.configs import granite_moe_1b_a400m as t_granite
from repro_torch.configs import qwen3_moe_235b_a22b as t_qwen3
from repro_torch.models import moe as tm

SMOKES = {"granite": (t_granite.SMOKE_CONFIG, j_granite.SMOKE_CONFIG),
          "qwen3": (t_qwen3.SMOKE_CONFIG, j_qwen3.SMOKE_CONFIG)}
NAMES = ("router", "experts_gate", "experts_in", "experts_out")


def _rel(a, b):
    a = a.detach().to(torch.float32).numpy() if torch.is_tensor(a) else np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _layer(arch, dtype, capacity_factor=None, seed=0):
    """(port cfg, reference cfg, port params, reference params)."""
    tcfg, jcfg = SMOKES[arch]
    if capacity_factor is not None:
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
            tcfg.moe, capacity_factor=capacity_factor))
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, capacity_factor=capacity_factor))
    tcfg, jcfg = (dataclasses.replace(c, dtype=dtype) for c in (tcfg, jcfg))
    pj = jm.init_moe(jax.random.PRNGKey(seed), jcfg)
    wdt = getattr(torch, dtype)
    pt = {k: torch.tensor(np.asarray(v)).to(torch.float32 if k == "router" else wdt)
          for k, v in pj.items()}
    return tcfg, jcfg, pt, pj


def _x(shape, dtype, seed):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return jnp.asarray(x, dtype), torch.tensor(x).to(getattr(torch, dtype))


def _reference_routing(x, router, top_k, E, capacity):
    """The reference's routing (``_moe_local``, moe.py:88-103) in jnp on
    its own arrays: the chosen experts and which assignments are kept."""
    logits = x.astype(jnp.float32) @ router.astype(jnp.float32)
    _, gate_e = jax.lax.top_k(logits, top_k)
    flat_e = gate_e.reshape(-1)
    onehot = jax.nn.one_hot(flat_e, E, dtype=jnp.int32)
    rank = ((jnp.cumsum(onehot, axis=0) - onehot) * onehot).sum(-1)
    return np.asarray(flat_e), np.asarray(rank < capacity)


@pytest.mark.parametrize("arch", sorted(SMOKES))
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 3e-2)])
@pytest.mark.parametrize("cf", [None, 0.5])          # the config's, and one that drops
def test_moe_layer_matches_reference(arch, dtype, tol, cf):
    tcfg, jcfg, pt, pj = _layer(arch, dtype, cf)
    B, T = 2, 24
    jx, tx = _x((B, T, tcfg.d_model), dtype, 1)
    want = jm.moe_layer(pj, jx, jcfg)
    got = tm.moe_layer(pt, tx, tcfg)
    assert got.dtype == tx.dtype and got.shape == (B, T, tcfg.d_model)
    assert _rel(got, want.astype(jnp.float32)) < tol

    m = tcfg.moe
    cap = tm.capacity(B * T, tcfg)
    assert cap == max(int(np.ceil(B * T * m.top_k / m.num_experts * m.capacity_factor)), 1)
    flat_e, _, _, keep = tm.route(tx.reshape(B * T, -1), pt["router"], top_k=m.top_k,
                                  capacity=cap)
    want_e, want_keep = _reference_routing(jx.reshape(B * T, -1), pj["router"], m.top_k,
                                           m.num_experts, cap)
    np.testing.assert_array_equal(flat_e.numpy(), want_e)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    if cf == 0.5:
        assert not want_keep.all()                   # this batch does drop


@pytest.mark.parametrize("N", [1, 4])
def test_decode_sized_calls_drop_as_the_reference_does(N):
    """A decode step routes N tokens with capacity ceil(N k / E cf): batch
    4 of granite's smoke config (E 4, k 2) has capacity 3 for up to 4
    tokens on an expert; one token never drops (its k experts are
    distinct)."""
    tcfg, jcfg, pt, pj = _layer("granite", "float32", seed=2)
    jx, tx = _x((N, 1, tcfg.d_model), "float32", 3)
    assert _rel(tm.moe_layer(pt, tx, tcfg), jm.moe_layer(pj, jx, jcfg)) < 1e-5
    m = tcfg.moe
    *_, keep = tm.route(tx.reshape(N, -1), pt["router"], top_k=m.top_k,
                        capacity=tm.capacity(N, tcfg))
    if N == 1:
        assert bool(keep.all())


@pytest.mark.parametrize("N,cap", [(1, 1), (16, 2), (16, 5), (40, 64)])
def test_route_slots_fill_each_expert_in_order(N, cap):
    """Kept assignments take distinct rows, expert-major, each expert's
    first ``min(count, cap)`` in token-major order; the rest land in the
    overflow bin, the gather buffer's last row."""
    tcfg, _, pt, _ = _layer("qwen3", "float32", seed=6)
    E, k = tcfg.moe.num_experts, tcfg.moe.top_k
    _, tx = _x((N, tcfg.d_model), "float32", 7)
    flat_e, flat_w, slot, keep = tm.route(tx, pt["router"], top_k=k, capacity=cap)
    flat_e, slot, keep = flat_e.numpy(), slot.numpy(), keep.numpy()
    torch.testing.assert_close(flat_w.reshape(N, k).sum(-1), torch.ones(N))
    seen = np.zeros(E, np.int64)
    for a, e in enumerate(flat_e):
        if seen[e] < cap:
            assert keep[a] and slot[a] == e * cap + seen[e]
        else:
            assert not keep[a] and slot[a] == E * cap
        seen[e] += 1


def test_router_is_stored_f32():
    cfg = t_granite.SMOKE_CONFIG
    p = tm.init_moe(torch.Generator().manual_seed(0), cfg, torch.bfloat16, "cpu")
    assert p["router"].dtype == torch.float32
    assert {p[n].dtype for n in NAMES[1:]} == {torch.bfloat16}


@pytest.mark.parametrize("E,ranks,seed", [(16, 4, 0), (32, 8, 1), (10, 3, 2)])
def test_expert_placement_matches_reference(E, ranks, seed):
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, 500, E).astype(np.float64)
    co = rng.integers(0, 20, (E, E)) * (rng.random((E, E)) < 0.4)
    co = np.triu(co, 1) + np.triu(co, 1).T
    assign = tm.expert_placement(counts, co, ranks)
    np.testing.assert_array_equal(assign, jm.expert_placement(counts, co, ranks))
    if E % ranks == 0:
        perm = tm.placement_permutation(assign, ranks)
        np.testing.assert_array_equal(perm, jm.placement_permutation(assign, ranks))
        assert sorted(perm.tolist()) == list(range(E))
