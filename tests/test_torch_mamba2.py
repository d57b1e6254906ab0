"""The port's Mamba-2 block (``models/mamba2.py``) against the reference's
on the CPU: the segment sums, the chunked SSD (chunks that divide T, the
one-chunk fallback, a carried state, bf16 intermediates), the layer in
prefill and decode, and the state it returns.

Weights come from the reference's ``init_mamba``; activations are made with
numpy from a seed.  Tolerances: f32 within 1e-5 rel L2 (f32 products summed
in another order); bf16 within 3e-2 (bf16 rounds at other places, about
4e-3 a rounding).  A state's dtype must equal the reference's.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import mamba2_13b as j_mb
from repro.models import mamba2 as jmb

from repro_torch.configs import mamba2_13b as t_mb
from repro_torch.models import mamba2 as tmb

F32_NAMES = {"a_log", "dt_bias", "d_skip"}


def _rel(a, b):
    a = a.detach().to(torch.float32).numpy() if torch.is_tensor(a) else np.asarray(a, np.float32)
    b = np.asarray(jnp.asarray(b, jnp.float32))
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _both(a, dtype="float32"):
    a = np.asarray(a, np.float32)
    return jnp.asarray(a, dtype), torch.tensor(a).to(getattr(torch, dtype))


def _layer(dtype, seed=0):
    tcfg = dataclasses.replace(t_mb.SMOKE_CONFIG, dtype=dtype)
    jcfg = dataclasses.replace(j_mb.SMOKE_CONFIG, dtype=dtype)
    pj = jmb.init_mamba(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)
    # zero or one at init: draw them so that they count
    pj = dict(pj, **{k: jnp.asarray(rng.normal(scale=0.5, size=pj[k].shape), jnp.float32)
                     for k in ("conv_b", "dt_bias", "d_skip")})
    wdt = getattr(torch, dtype)
    pt = {k: torch.tensor(np.asarray(v)).to(torch.float32 if k in F32_NAMES else wdt)
          for k, v in pj.items()}
    return tcfg, jcfg, pt, pj


def test_segsum():
    ja, ta = _both(np.random.default_rng(0).normal(size=(2, 3, 9)))
    got, want = tmb._segsum(ta), np.asarray(jmb._segsum(ja))
    np.testing.assert_array_equal(np.isinf(got.numpy()), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got.numpy()[fin], want[fin], rtol=1e-6, atol=1e-6)


def _ssd_inputs(T, seed, H=4, P=8, N=16):
    rng = np.random.default_rng(seed)
    x = _both(rng.normal(size=(2, T, H, P)))
    dt = _both(rng.uniform(0.05, 1.0, size=(2, T, H)))
    a = _both(-rng.uniform(0.5, 4.0, size=(H,)))
    Bm = _both(rng.normal(size=(2, T, N)))
    Cm = _both(rng.normal(size=(2, T, N)))
    s0 = _both(rng.normal(size=(2, H, P, N)))
    return x, dt, a, Bm, Cm, s0


@pytest.mark.parametrize("T,chunk", [(32, 8), (30, 8), (16, 32)])   # chunks; fallback; one
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("big", [None, "bfloat16"])
def test_ssd_chunked(T, chunk, with_state, big):
    x, dt, a, Bm, Cm, s0 = _ssd_inputs(T, T + chunk)
    jy, jfin = jmb._ssd_chunked(x[0], dt[0], a[0], Bm[0], Cm[0], chunk,
                                s0[0] if with_state else None,
                                big_dtype=None if big is None else jnp.bfloat16)
    ty, tfin = tmb._ssd_chunked(x[1], dt[1], a[1], Bm[1], Cm[1], chunk,
                                s0[1] if with_state else None,
                                big_dtype=None if big is None else torch.bfloat16)
    tol = 1e-5 if big is None else 1e-4          # bf16 rounding of the same operands
    assert _rel(ty, jy) < tol and _rel(tfin, jfin) < tol


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 3e-2)])
@pytest.mark.parametrize("T", [64, 40])          # two chunks of 32; the fallback
def test_mamba_layer_prefill(dtype, tol, T):
    tcfg, jcfg, pt, pj = _layer(dtype)
    jx, tx = _both(np.random.default_rng(2).normal(size=(2, T, tcfg.d_model)), dtype)
    jout, jst = jmb.mamba_layer(pj, jx, jcfg)
    tout, tst = tmb.mamba_layer(pt, tx, tcfg)
    assert tout.dtype == tx.dtype and _rel(tout, jout) < tol
    assert _rel(tst["ssm"], jst["ssm"]) < tol and _rel(tst["conv"], jst["conv"]) < tol
    assert tst["ssm"].dtype == torch.float32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [1, 8])                      # a decode step; a segment
def test_mamba_layer_from_a_state(dtype, T):
    """From a carried state: one step of the recurrence (T = 1) or the
    chunked scan from it.  The conv tail starts bf16, as ``init_cache``
    makes it, and comes back in the dtype the reference returns."""
    tcfg, jcfg, pt, pj = _layer(dtype, seed=3)
    m = tcfg.mamba
    d_in = m.expand * tcfg.d_model
    H = d_in // m.head_dim
    rng = np.random.default_rng(4)
    jx, tx = _both(rng.normal(size=(2, T, tcfg.d_model)), dtype)
    jssm, tssm = _both(rng.normal(size=(2, H, m.head_dim, m.d_state)))
    jc, tc = _both(rng.normal(size=(2, m.d_conv - 1, d_in + 2 * m.d_state)), "bfloat16")
    jout, jst = jmb.mamba_layer(pj, jx, jcfg, {"ssm": jssm, "conv": jc})
    tout, tst = tmb.mamba_layer(pt, tx, tcfg, {"ssm": tssm, "conv": tc})
    tol = 1e-5 if dtype == "float32" else 3e-2
    assert _rel(tout, jout) < tol
    for k in ("ssm", "conv"):
        assert _rel(tst[k], jst[k]) < tol
        assert str(tst[k].dtype).split(".")[-1] == str(jst[k].dtype)


def test_init_state_and_stored_dtypes():
    cfg = t_mb.SMOKE_CONFIG
    st = tmb.init_mamba_state(cfg, 3, torch.bfloat16, "cpu")
    jst = jmb.init_mamba_state(j_mb.SMOKE_CONFIG, 3, jnp.bfloat16)
    for k in ("ssm", "conv"):
        assert tuple(st[k].shape) == jst[k].shape
        assert str(st[k].dtype).split(".")[-1] == str(jst[k].dtype)
    p = tmb.init_mamba(torch.Generator().manual_seed(0), cfg, torch.bfloat16, "cpu")
    assert {k for k, v in p.items() if v.dtype == torch.float32} == F32_NAMES
    jp = jmb.init_mamba(jax.random.PRNGKey(0), j_mb.SMOKE_CONFIG)
    assert {k: tuple(v.shape) for k, v in p.items()} == {k: v.shape for k, v in jp.items()}
