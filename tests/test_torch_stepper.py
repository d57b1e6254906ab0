"""Two RK2 steps of the port against the reference's serial plain route.

The lattice keeps every particle well inside its leaf box, so the f32
roundoff between the two routes cannot move a particle across a box edge:
the rebinned trees must then agree in every mask bit, and positions to
1e-6 absolute.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.core import quadtree as jqt
from repro.core import stepper as jst
from repro_torch.core import health as hw
from repro_torch.core import quadtree as qt
from repro_torch.core.stepper import rk2_step


def _lattice(level=3, per_side=3, seed=0):
    """``per_side**2`` particles per leaf box at 30-70% of its width."""
    n, h = 1 << level, qt.box_size(level)
    offs = np.linspace(0.3, 0.7, per_side)
    cells = np.arange(n)
    x = ((cells[:, None] + offs[None, :]) * h).ravel()
    X, Y = np.meshgrid(x, x, indexing="xy")
    pos = np.stack([X.ravel(), Y.ravel()], axis=1)
    gamma = 0.01 * np.random.default_rng(seed).normal(size=len(pos))
    return pos, gamma


@pytest.mark.parametrize("guard,with_payload,p", [(True, True, 8),
                                                  (False, False, 17)])
def test_two_rk2_steps_match_reference(guard, with_payload, p):
    pos, gamma = _lattice()
    level, dt, slots = 3, 0.01, 12
    jt, _ = jqt.build_tree(pos, gamma, level=level, sigma=0.02, slots=slots)
    tt, _ = qt.build_tree(pos, gamma, level=level, sigma=0.02, slots=slots,
                          device="cpu")
    label = np.arange(np.asarray(jt.z).size, dtype=np.int32).reshape(jt.z.shape)
    jpay = jnp.asarray(label) if with_payload else None
    tpay = torch.as_tensor(label) if with_payload else None
    for _ in range(2):
        jt, jpay, jok, jocc, jh = jst.rk2_step(jt, dt, jpay, p=p, guard=guard)
        tt, tpay, tok, tocc, th = rk2_step(tt, dt, tpay, p=p, guard=guard,
                                           device="cpu")
        np.testing.assert_array_equal(tt.mask.numpy(), np.asarray(jt.mask))
        np.testing.assert_allclose(tt.z.numpy(), np.asarray(jt.z), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(tt.q.numpy(), np.asarray(jt.q))
        assert bool(tok) == bool(jok) and int(tocc) == int(jocc)
        if with_payload:
            np.testing.assert_array_equal(tpay.numpy(), np.asarray(jpay))
        if guard:
            np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
            assert hw.ok(th)
        else:
            assert th is None and jh is None
    # the particles moved, and none crossed a box edge
    start, _ = qt.build_tree(pos, gamma, level=level, sigma=0.02, slots=slots,
                             device="cpu")
    assert not torch.equal(tt.z, start.z)
    assert torch.equal(tt.mask, start.mask)


def test_rk2_step_flags_overflow_like_reference():
    """A step that packs particles past the slot capacity: ok is False, the
    health word carries the overflow bit and the dropped count."""
    pos, gamma = _lattice(level=2, per_side=3, seed=1)
    gamma = gamma * 0.0
    gamma[0] = 50.0          # one strong vortex sweeps its neighbours along
    jt, _ = jqt.build_tree(pos, gamma, level=2, sigma=0.02, slots=9)
    tt, _ = qt.build_tree(pos, gamma, level=2, sigma=0.02, slots=9, device="cpu")
    jr = jst.rk2_step(jt, 0.02, p=8, guard=True)
    tr = rk2_step(tt, 0.02, p=8, guard=True, device="cpu")
    assert not bool(tr[2]) and not bool(jr[2])
    assert int(tr[3]) == int(jr[3])
    np.testing.assert_array_equal(tr[4].numpy(), np.asarray(jr[4]))
    assert tr[4][hw.F_OVERFLOW] == 1 and tr[4][hw.F_DROPPED] > 0
    assert not hw.ok(tr[4])
