"""Gradients of the port against ``jax.grad`` of the reference, on the CPU.

Every LM architecture of the registry at its smoke config cast to f32:
the reference's ``make_loss_fn(cfg, None)`` differentiated by
``jax.value_and_grad`` on its own weights, and the port's loss
(``train/loop.py``) differentiated by ``torch.autograd.grad`` on the same
weights carried across by ``convert.params_from_jax``, on one batch made
with numpy from a seed, with ``remat`` off and on.  Then the recurrent
parts alone: the RG-LRU's doubling scan under autograd (out of place)
gives the values of its serving form (in place) bit for bit, the SSD's
chunked form those of its former in-place form, and their gradients are
the reference's.

Tolerances: losses within 1e-5 (f32 sums over 64 positions in another
order); each parameter's gradient within 1e-4 rel L2 (f32 sums of a few
layers in another order: the largest seen is 2.4e-5, the SSD's); the parts'
gradients within 1e-5 rel L2.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import registry as jreg
from repro.models import mamba2 as jm
from repro.models import rglru as jr
from repro.models import transformer as jt
from repro.train import loop as jloop

from repro_torch.configs import registry
from repro_torch.models import mamba2 as tm
from repro_torch.models import rglru as tr
from repro_torch.models.convert import params_from_jax
from repro_torch.models.transformer import param_tensors
from repro_torch.train import loop as tloop

CPU = torch.device("cpu")
# biases and skips the reference initialises to zero or one, drawn so
# that their gradients are tested against nonzero values
DRAWN = ("b_q", "b_k", "b_v", "lru_ba", "lru_bi", "conv_b", "dt_bias", "d_skip")
B, T, CHUNK = 2, 64, 16      # 4 query and loss chunks; 2 SSD chunks at the smoke chunk 32


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _draw(tree, rng):
    for k, v in tree.items():
        if isinstance(v, dict):
            _draw(v, rng)
        elif k in DRAWN:
            tree[k] = rng.normal(scale=0.3, size=v.shape).astype(np.float32)


def _f32(reg, arch):
    return dataclasses.replace(reg.get_smoke_config(arch), dtype="float32")


def _batch(cfg, seed=1):
    """tokens, labels (one masked besides the last) and, for a vlm, patch
    embeddings; T positions in all."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (B, T - cfg.num_patches)).astype(np.int32)
    labels = np.concatenate([tokens[:, 1:], np.full((B, 1), -1, np.int32)], axis=1)
    labels[0, 3] = -1
    batch = {"tokens": tokens, "labels": labels}
    if cfg.num_patches:
        batch["patch_embeds"] = rng.normal(
            size=(B, cfg.num_patches, cfg.patch_dim)).astype(np.float32)
    return batch


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """(reference weights as numpy, the batch, loss, flat gradients): one
    ``jax.value_and_grad`` an architecture, shared by both remat cases."""
    jcfg = _f32(jreg, arch)
    pnp = jax.tree.map(np.asarray, jt.init_params(jax.random.PRNGKey(0), jcfg))
    for group in pnp["groups"]:
        for tree in group:
            _draw(tree, np.random.default_rng(0))
    batch = _batch(jcfg)
    loss_fn = jloop.make_loss_fn(jcfg, None, q_chunk=CHUNK, loss_chunk=CHUNK, remat=False)
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
        jax.tree.map(jnp.asarray, pnp), {k: jnp.asarray(v) for k, v in batch.items()})
    flat = params_from_jax(jax.tree.map(np.asarray, grads), _f32(registry, arch), CPU)
    return pnp, batch, float(loss), [g.numpy() for g in param_tensors(flat)]


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", registry.lm_archs())
def test_loss_and_every_gradient_match_the_reference(arch, remat):
    """Every family (dense, moe, hybrid, ssm, audio, vlm): the hybrid's and
    the SSM's recurrent layers included, which wrote autograd's saved
    tensors in place before."""
    pnp, batch_np, want_loss, want = _reference(arch)
    cfg = _f32(registry, arch)
    params = params_from_jax(pnp, cfg, CPU)
    batch = {k: torch.tensor(v) for k, v in batch_np.items()}
    batch["tokens"], batch["labels"] = batch["tokens"].long(), batch["labels"].long()
    loss_fn = tloop.make_loss_fn(cfg, q_chunk=CHUNK, loss_chunk=CHUNK, remat=remat)
    loss, grads = tloop.value_and_grad(loss_fn, params, batch)
    assert abs(float(loss) - want_loss) < 1e-5
    names = _names(params)
    assert len(grads) == len(want) == len(names)
    errs = {n: _rel(g.numpy(), w) for n, g, w in zip(names, grads, want)}
    assert max(errs.values()) < 1e-4, sorted(errs.items(), key=lambda kv: -kv[1])[:3]
    assert [n for n, g in zip(names, grads) if not g.abs().max() > 0] == []
    for g, t in zip(grads, param_tensors(params)):
        assert g.dtype == t.dtype and g.shape == t.shape


def _names(tree, prefix=""):
    """Leaf paths in ``param_tensors``' order."""
    if isinstance(tree, torch.Tensor):
        return [prefix]
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    return [n for k, v in items for n in _names(v, f"{prefix}/{k}")]


# ---------------------------------------------------------------------------
# the recurrent parts alone
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_h0", [False, True])
def test_lru_scan_under_autograd_is_the_in_place_scan_with_the_reference_gradient(with_h0):
    rng = np.random.default_rng(3)
    a = rng.uniform(0.2, 0.99, (2, 64, 8)).astype(np.float32)
    b = rng.normal(size=(2, 64, 8)).astype(np.float32)
    h0 = rng.normal(size=(2, 8)).astype(np.float32) if with_h0 else None
    w = rng.normal(size=(2, 64, 8)).astype(np.float32)      # a random cotangent
    at, bt = torch.tensor(a, requires_grad=True), torch.tensor(b, requires_grad=True)
    h0t = None if h0 is None else torch.tensor(h0, requires_grad=True)
    out = tr._lru_scan(at, bt, h0t)                 # under autograd: out of place
    with torch.no_grad():
        served = tr._lru_scan(at, bt, h0t)          # serving: in place, as before
    assert out.grad_fn is not None and torch.equal(out, served)
    inputs = [at, bt] + ([h0t] if with_h0 else [])
    got = torch.autograd.grad((out * torch.tensor(w)).sum(), inputs)

    @jax.jit
    def f(*args):
        return (jr._lru_scan(args[0], args[1], args[2] if with_h0 else None) * w).sum()
    want = jax.grad(f, argnums=tuple(range(len(inputs))))(
        *[jnp.asarray(x) for x in (a, b, h0) if x is not None])
    for g, wg in zip(got, want):
        assert _rel(g.numpy(), wg) < 1e-5


def _ssd_in_place(x, dt, a, Bm, Cm, chunk, s):
    """The port's former chunked SSD (f32, T a multiple of the chunk), whose
    weights W were built in place."""
    B_, T, H, P_ = x.shape
    N, l = Bm.shape[-1], chunk
    nc = T // l
    xr, dtr = x.reshape(B_, nc, l, H, P_), dt.reshape(B_, nc, l, H)
    Br, Cr = Bm.reshape(B_, nc, l, N), Cm.reshape(B_, nc, l, N)
    dA = dtr * a
    dA_cum = torch.cumsum(dA, dim=2)
    S = torch.einsum("bcln,bcsn->bcls", Cr, Br)
    cs = torch.cumsum(dA.permute(0, 1, 3, 2), dim=-1)
    W = (cs[..., :, None] - cs[..., None, :]).masked_fill_(
        torch.ones((l, l), dtype=torch.bool).triu_(1), float("-inf")).exp_()
    W.mul_(S[:, :, None])
    Y = torch.einsum("bchls,bcshp->bclhp", W, xr * dtr[..., None])
    decay_states = torch.exp(dA_cum[:, :, -1:, :] - dA_cum)
    states = torch.einsum("bcln,bclhp->bchpn", Br, xr * (decay_states * dtr)[..., None])
    chunk_decay = torch.exp(dA_cum[:, :, -1, :])
    prev = []
    for c in range(nc):
        prev.append(s)
        s = s * chunk_decay[:, c][..., None, None] + states[:, c]
    Y_off = torch.einsum("bcln,bchpn->bclhp", Cr, torch.stack(prev, dim=1))
    Y = Y + Y_off * torch.exp(dA_cum)[..., None]
    return Y.reshape(B_, T, H, P_), s


def test_ssd_chunked_is_the_in_place_form_and_has_the_reference_gradient():
    """(1, 64, 2, 4), N = 8, chunk 32, from a nonzero state."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(1, 64, 2, 4)).astype(np.float32)
    dt = rng.uniform(0.01, 0.2, (1, 64, 2)).astype(np.float32)
    a = -rng.uniform(0.5, 2.0, 2).astype(np.float32)
    Bm = rng.normal(size=(1, 64, 8)).astype(np.float32)
    Cm = rng.normal(size=(1, 64, 8)).astype(np.float32)
    s0 = rng.normal(size=(1, 2, 4, 8)).astype(np.float32)
    wy = rng.normal(size=(1, 64, 2, 4)).astype(np.float32)     # random cotangents
    ws = rng.normal(size=(1, 2, 4, 8)).astype(np.float32)
    args = [torch.tensor(v, requires_grad=True) for v in (x, dt, a, Bm, Cm, s0)]
    y, final = tm._ssd_chunked(*args[:5], 32, args[5])
    with torch.no_grad():
        y_old, final_old = _ssd_in_place(*args[:5], 32, args[5])
    assert torch.equal(y, y_old) and torch.equal(final, final_old)

    got = torch.autograd.grad((y * torch.tensor(wy)).sum() + (final * torch.tensor(ws)).sum(),
                              args)

    @jax.jit
    def f(*xs):
        yj, fj = jm._ssd_chunked(*xs[:5], 32, xs[5])
        return (yj * wy).sum() + (fj * ws).sum()
    want = jax.grad(f, argnums=tuple(range(6)))(
        *[jnp.asarray(v) for v in (x, dt, a, Bm, Cm, s0)])
    for g, wg in zip(got, want):
        assert _rel(g.numpy(), wg) < 1e-5
