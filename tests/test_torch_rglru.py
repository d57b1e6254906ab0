"""The port's RG-LRU block (``models/rglru.py``) against the reference's on
the CPU: the causal conv, the scan, the layer in prefill and decode, and
the state it returns.

Weights come from the reference's ``init_rglru``; activations are made with
numpy from a seed.  Tolerances: f32 within 1e-5 rel L2 (the port's doubling
scan and the reference's ``associative_scan`` add in other orders; gelu's
tanh form in another library); bf16 within 3e-2 (bf16 rounds at other
places, about 4e-3 a rounding).  A state's dtype must equal the
reference's: an f32 layer given a bf16 conv tail returns an f32 one.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import recurrentgemma_2b as j_rg
from repro.models import rglru as jr

from repro_torch.configs import recurrentgemma_2b as t_rg
from repro_torch.models import rglru as tr

F32_NAMES = {"lru_wa", "lru_wi", "lru_lambda", "lru_ba", "lru_bi"}


def _rel(a, b):
    a = a.detach().to(torch.float32).numpy() if torch.is_tensor(a) else np.asarray(a, np.float32)
    b = np.asarray(jnp.asarray(b, jnp.float32))
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _both(a, dtype="float32"):
    a = np.asarray(a, np.float32)
    return jnp.asarray(a, dtype), torch.tensor(a).to(getattr(torch, dtype))


def _layer(dtype, seed=0):
    tcfg = dataclasses.replace(t_rg.SMOKE_CONFIG, dtype=dtype)
    jcfg = dataclasses.replace(j_rg.SMOKE_CONFIG, dtype=dtype)
    pj = jr.init_rglru(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)
    # biases are zero at init: draw them so that they count
    pj = dict(pj, lru_ba=jnp.asarray(rng.normal(size=pj["lru_ba"].shape), jnp.float32),
              lru_bi=jnp.asarray(rng.normal(size=pj["lru_bi"].shape), jnp.float32))
    wdt = getattr(torch, dtype)
    pt = {k: torch.tensor(np.asarray(v)).to(torch.float32 if k in F32_NAMES else wdt)
          for k, v in pj.items()}
    return tcfg, jcfg, pt, pj


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv4(with_state):
    rng = np.random.default_rng(1)
    jx, tx = _both(rng.normal(size=(2, 9, 16)))
    jw, tw = _both(rng.normal(size=(4, 16)))
    js, ts = _both(rng.normal(size=(2, 3, 16))) if with_state else (None, None)
    jy, jtail = jr._causal_conv4(jx, jw, js)
    ty, ttail = tr._causal_conv4(tx, tw, ts)
    assert _rel(ty, jy) < 1e-6 and _rel(ttail, jtail) < 1e-7


@pytest.mark.parametrize("T", [1, 7, 64, 100])
@pytest.mark.parametrize("with_h0", [False, True])
def test_lru_scan(T, with_h0):
    rng = np.random.default_rng(T)
    ja, ta = _both(rng.uniform(0.5, 1.0, size=(2, T, 8)))
    jb, tb = _both(rng.normal(size=(2, T, 8)))
    jh, th = _both(rng.normal(size=(2, 8))) if with_h0 else (None, None)
    assert _rel(tr._lru_scan(ta, tb, th), jr._lru_scan(ja, jb, jh)) < 1e-5


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 3e-2)])
def test_rglru_layer_prefill(dtype, tol):
    tcfg, jcfg, pt, pj = _layer(dtype)
    jx, tx = _both(np.random.default_rng(2).normal(size=(2, 20, tcfg.d_model)), dtype)
    jout, jst = jr.rglru_layer(pj, jx, jcfg)
    tout, tst = tr.rglru_layer(pt, tx, tcfg)
    assert tout.dtype == tx.dtype and _rel(tout, jout) < tol
    assert _rel(tst["h"], jst["h"]) < tol and _rel(tst["conv"], jst["conv"]) < tol
    assert tst["h"].dtype == torch.float32 and jst["h"].dtype == jnp.float32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [1, 6])                      # a decode step; a segment
def test_rglru_layer_from_a_state(dtype, T):
    """From a carried state: one step of the recurrence (T = 1) or the scan
    with h0 folded in.  The conv tail starts bf16, as ``init_cache`` makes
    it, and comes back in the dtype the reference returns."""
    tcfg, jcfg, pt, pj = _layer(dtype, seed=3)
    rng = np.random.default_rng(4)
    W = tcfg.rglru.lru_width
    jx, tx = _both(rng.normal(size=(2, T, tcfg.d_model)), dtype)
    jh, th = _both(rng.normal(size=(2, W)))
    jc, tc = _both(rng.normal(size=(2, 3, W)), "bfloat16")
    jout, jst = jr.rglru_layer(pj, jx, jcfg, {"h": jh, "conv": jc})
    tout, tst = tr.rglru_layer(pt, tx, tcfg, {"h": th, "conv": tc})
    tol = 1e-5 if dtype == "float32" else 3e-2
    assert _rel(tout, jout) < tol
    for k in ("h", "conv"):
        assert _rel(tst[k], jst[k]) < tol
        assert str(tst[k].dtype).split(".")[-1] == str(jst[k].dtype)


def test_init_state_and_stored_dtypes():
    cfg = t_rg.SMOKE_CONFIG
    st = tr.init_rglru_state(cfg, 3, torch.bfloat16, "cpu")
    jst = jr.init_rglru_state(j_rg.SMOKE_CONFIG, 3, jnp.bfloat16)
    for k in ("h", "conv"):
        assert tuple(st[k].shape) == jst[k].shape
        assert str(st[k].dtype).split(".")[-1] == str(jst[k].dtype)
    p = tr.init_rglru(torch.Generator().manual_seed(0), cfg, torch.bfloat16, "cpu")
    assert {k for k, v in p.items() if v.dtype == torch.float32} == F32_NAMES
