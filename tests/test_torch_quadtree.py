"""The port's quadtree against the reference: tables, operator builders,
``build_tree`` and ``rebuild_tree`` bit for bit."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.core import expansions as jex
from repro.core import quadtree as jqt
from repro_torch.core import expansions as ex
from repro_torch.core import quadtree as qt


def _case(n, level, seed, lo=0.0, hi=1.0):
    rng = np.random.default_rng(seed)
    return rng.uniform(lo, hi, size=(n, 2)), rng.normal(size=n)


def test_offset_tables_identical():
    assert qt.M2L_OFFSETS == jqt.M2L_OFFSETS
    assert qt.P2P_OFFSETS == jqt.P2P_OFFSETS
    assert qt.PARENT_NEIGH8 == jqt.PARENT_NEIGH8
    assert qt.M2L_PARITY_OFFSETS == jqt.M2L_PARITY_OFFSETS
    np.testing.assert_array_equal(qt.M2L_VALIDITY, jqt.M2L_VALIDITY)
    assert ex.CHILD_OFFSETS == jex.CHILD_OFFSETS


def test_morton_and_geometry_identical():
    ix = np.arange(0, 1000, 7)
    iy = np.arange(1000, 0, -7)
    code = qt.morton_encode(ix, iy)
    np.testing.assert_array_equal(code, jqt.morton_encode(ix, iy))
    for a, b in zip(qt.morton_decode(code), jqt.morton_decode(code)):
        np.testing.assert_array_equal(a, b)
    for level in (0, 3, 6):
        np.testing.assert_array_equal(qt.box_centers(level), jqt.box_centers(level))
        assert qt.box_size(level) == jqt.box_size(level)
    for n in (10, 5000, 765_625):
        assert qt.choose_level(n) == jqt.choose_level(n)
        assert qt.choose_level(n, 1.0) == jqt.choose_level(n, 1.0)
    pos, _ = _case(50, 3, 1, -0.5, 2.0)
    a, b = qt.Domain.covering(pos), jqt.Domain.covering(pos)
    assert (a.origin, a.size) == (b.origin, b.size)
    np.testing.assert_array_equal(a.to_unit(pos), b.to_unit(pos))


@pytest.mark.parametrize("p", [8, 17])
def test_operator_builders_identical(p):
    for name in ("m2m_operator", "l2l_operator", "m2l_operator",
                 "m2l_folded_operator"):
        np.testing.assert_array_equal(getattr(ex, name)(p), getattr(jex, name)(p))
    base = np.random.default_rng(p).normal(size=(40, p, p)) + 0j
    np.testing.assert_array_equal(ex.fold_operator(base, p),
                                  jex.fold_operator(base, p))


@pytest.mark.parametrize("level,n,slots", [(2, 300, None), (3, 1000, None),
                                           (4, 2000, 40)])
def test_build_tree_identical(level, n, slots):
    pos, gamma = _case(n, level, level)
    jt, ji = jqt.build_tree(pos, gamma, level=level, sigma=0.02, slots=slots)
    tt, ti = qt.build_tree(pos, gamma, level=level, sigma=0.02, slots=slots,
                           device="cpu")
    np.testing.assert_array_equal(tt.z.numpy(), np.asarray(jt.z))
    np.testing.assert_array_equal(tt.q.numpy(), np.asarray(jt.q))
    np.testing.assert_array_equal(tt.mask.numpy(), np.asarray(jt.mask))
    np.testing.assert_array_equal(ti.counts, ji.counts)
    np.testing.assert_array_equal(ti.box_of_particle, ji.box_of_particle)
    np.testing.assert_array_equal(ti.slot_of_particle, ji.slot_of_particle)
    assert (tt.level, tt.sigma, tt.slots) == (jt.level, jt.sigma, jt.slots)
    assert tt.z.dtype == torch.complex64 and tt.mask.dtype == torch.bool
    # the slots read back into input order
    back = qt.gather_particle_values(tt.z, ti).numpy()
    np.testing.assert_array_equal(back, np.asarray(
        jqt.gather_particle_values(np.asarray(jt.z), ji)))


def test_build_tree_rejects_overflow():
    pos = np.full((5, 2), 0.1)
    with pytest.raises(ValueError, match="exceeds slot capacity"):
        qt.build_tree(pos, np.ones(5), level=2, sigma=0.01, slots=4, device="cpu")


def test_tree_from_numpy_carries_reference_state():
    pos, gamma = _case(400, 3, 4)
    jt, _ = jqt.build_tree(pos, gamma, level=3, sigma=0.03)
    tt = qt.tree_from_numpy(np.asarray(jt.z), np.asarray(jt.q),
                            np.asarray(jt.mask), jt.level, jt.sigma, "cpu")
    np.testing.assert_array_equal(tt.z.numpy(), np.asarray(jt.z))
    np.testing.assert_array_equal(tt.q.numpy(), np.asarray(jt.q))
    assert int(tt.num_particles) == int(jt.num_particles) == 400


def _rebuild_both(level, n, slots, seed, kick):
    pos, gamma = _case(n, level, seed, 0.05, 0.95)
    jt, _ = jqt.build_tree(pos, gamma, level=level, sigma=0.02, slots=slots)
    tt, _ = qt.build_tree(pos, gamma, level=level, sigma=0.02, slots=slots,
                          device="cpu")
    rng = np.random.default_rng(seed + 1)
    shape = np.asarray(jt.z).shape
    new_z = (np.asarray(jt.z)
             + kick * (rng.normal(size=shape) + 1j * rng.normal(size=shape))
             ).astype(np.complex64)
    tag = rng.integers(0, 1000, size=shape).astype(np.int32)
    jr = jqt.rebuild_tree(jt, jnp.asarray(new_z),
                          aux=(jnp.asarray(tag), {"w": jnp.asarray(new_z)}))
    tr = qt.rebuild_tree(tt, torch.as_tensor(new_z),
                         aux=(torch.as_tensor(tag), {"w": torch.as_tensor(new_z)}))
    return jr, tr


@pytest.mark.parametrize("level,n,slots,kick", [(2, 60, 8, 0.05), (3, 300, 16, 0.2),
                                                (4, 800, 12, 0.5)])
def test_rebuild_tree_bit_identical(level, n, slots, kick):
    (jt, jaux, jok), (tt, taux, tok) = _rebuild_both(level, n, slots, level, kick)
    np.testing.assert_array_equal(tt.z.numpy(), np.asarray(jt.z))
    np.testing.assert_array_equal(tt.q.numpy(), np.asarray(jt.q))
    np.testing.assert_array_equal(tt.mask.numpy(), np.asarray(jt.mask))
    np.testing.assert_array_equal(taux[0].numpy(), np.asarray(jaux[0]))
    np.testing.assert_array_equal(taux[1]["w"].numpy(), np.asarray(jaux[1]["w"]))
    assert bool(tok) == bool(jok)


def test_rebuild_tree_overflow_drops_like_reference():
    """Every particle kicked into a few boxes: both drop the same surplus."""
    (jt, jaux, jok), (tt, taux, tok) = _rebuild_both(2, 80, 16, 9, 0.0)
    z = np.asarray(jt.z)
    crowd = (0.3 + 0.3j) + 0.01 * (z - z.real.min())   # into a 1-2 box corner
    crowd = crowd.astype(np.complex64)
    jr = jqt.rebuild_tree(jt, jnp.asarray(crowd))
    tr = qt.rebuild_tree(tt, torch.as_tensor(crowd))
    assert not bool(jr[2]) and not bool(tr[2])
    np.testing.assert_array_equal(tr[0].z.numpy(), np.asarray(jr[0].z))
    np.testing.assert_array_equal(tr[0].mask.numpy(), np.asarray(jr[0].mask))
    assert tr[1] is None
    assert int(tr[0].num_particles) == int(jr[0].num_particles) < 80


def test_rebuild_tree_clamps_out_of_domain_like_reference():
    (jt, _, _), (tt, _, _) = _rebuild_both(3, 100, 12, 5, 0.0)
    z = np.asarray(jt.z).copy()
    live = np.argwhere(np.asarray(jt.mask))
    far = [-0.3 + 1.7j, 3.0 - 2.0j, complex(np.nan, 0.5),
           complex(np.inf, -np.inf)]
    for (y, x, k), value in zip(live[::7], far):   # slots in different boxes
        z[y, x, k] = value
    z = z.astype(np.complex64)
    jr = jqt.rebuild_tree(jt, jnp.asarray(z))
    tr = qt.rebuild_tree(tt, torch.as_tensor(z))
    np.testing.assert_array_equal(tr[0].z.numpy(), np.asarray(jr[0].z))
    np.testing.assert_array_equal(tr[0].mask.numpy(), np.asarray(jr[0].mask))
    assert bool(tr[2]) == bool(jr[2])
