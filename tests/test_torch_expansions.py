"""The port's expansion stages against the reference's jnp versions (rel
1e-5: the same f32 arithmetic in another summation order)."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.core import expansions as jex
from repro.core import quadtree as jqt
from repro_torch.core import expansions as ex
from repro_torch.kernels import ops

TOL = 1e-5


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _cplx(rng, shape):
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64)


def _both(fn_port, fn_ref, *arrays, **kw):
    port = fn_port(*(torch.as_tensor(a) if isinstance(a, np.ndarray) else a
                     for a in arrays), **kw)
    ref = fn_ref(*(jnp.asarray(a) if isinstance(a, np.ndarray) else a
                   for a in arrays), **kw)
    return port, ref


@pytest.mark.parametrize("level,p", [(2, 8), (3, 17), (4, 12)])
def test_p2m_l2p(level, p):
    n, s = 1 << level, 5
    rng = np.random.default_rng(level)
    r = jqt.box_size(level)
    centers = jqt.box_centers(level).astype(np.complex64)
    z = (centers[..., None] + r * 0.45 * (rng.uniform(-1, 1, (n, n, s))
                                          + 1j * rng.uniform(-1, 1, (n, n, s)))
         ).astype(np.complex64)
    q = _cplx(rng, (n, n, s))
    mask = rng.uniform(size=(n, n, s)) > 0.3
    me, jme = _both(ex.p2m, jex.p2m, z, q, mask, centers, r, p)
    assert _rel(me.numpy(), jme) < TOL
    le = _cplx(rng, (n, n, p))
    modes = ("value", "ngrad")
    out, jout = _both(ex.l2p_eval, jex.l2p_eval, le, z, centers, r, p, modes=modes)
    assert out.shape == jout.shape
    assert _rel(out.numpy(), jout) < TOL


def test_p2m_finite_for_empty_slots_at_depth():
    """Empty slots hold z = 0; at level 10, p = 17 the reference's
    ``zhat**16`` overflows float32 there and 0 * inf turns the ME to NaN.
    The port masks ``zhat`` of empty slots, so the ME stays finite and
    equals the ME of the live slots alone."""
    level, p = 10, 17
    r = jqt.box_size(level)
    centers = np.array([[0.9 + 0.9j, 0.9 + 0.91j]], np.complex64)
    z = np.zeros((1, 2, 2), np.complex64)
    z[..., 0] = centers + 1e-4
    q = np.ones((1, 2, 2), np.complex64)
    mask = np.zeros((1, 2, 2), bool)
    mask[..., 0] = True
    me, jme = _both(ex.p2m, jex.p2m, z, q, mask, centers, r, p)
    assert not np.isfinite(np.asarray(jme)).all()
    assert torch.isfinite(torch.view_as_real(me)).all()
    live, jlive = _both(ex.p2m, jex.p2m, z[..., :1], q[..., :1], mask[..., :1],
                        centers, r, p)
    assert _rel(me.numpy(), jlive) < TOL
    assert _rel(live.numpy(), jlive) < TOL


@pytest.mark.parametrize("shape", [(4, 4), (8, 6), (2, 10)])
@pytest.mark.parametrize("p", [8, 17])
def test_m2m_l2l_planes(shape, p):
    rng = np.random.default_rng(p + shape[1])
    child = _cplx(rng, shape + (p,))
    out, ref = _both(ex.m2m, jex.m2m, child, p)
    assert _rel(out.numpy(), ref) < TOL
    parent = _cplx(rng, (shape[0] // 2, shape[1] // 2, p))
    out, ref = _both(ex.l2l, jex.l2l, parent, p)
    assert _rel(out.numpy(), ref) < TOL
    planes, ref = _both(ex.to_parent_planes, jex.to_parent_planes, child, p)
    np.testing.assert_array_equal(planes.numpy(), np.asarray(ref))
    back = ex.from_parent_planes(planes, p)
    np.testing.assert_array_equal(back.numpy(), child)


@pytest.mark.parametrize("rows,row0,halo", [(8, 0, 2), (5, 3, 3), (6, 1, 3),
                                            (7, 2, 3), (4, 2, 2), (3, 1, 2)])
def test_m2l_slab_geometry(rows, row0, halo):
    try:
        want = jex.m2l_slab_geometry(rows, row0, halo)
    except ValueError:
        with pytest.raises(ValueError, match="too small"):
            ex.m2l_slab_geometry(rows, row0, halo)
        return
    assert ex.m2l_slab_geometry(rows, row0, halo) == want


@pytest.mark.parametrize("rows,cols,row0,halo,col0,col_halo", [
    (8, 8, 0, 2, 0, 0),      # full-width even slab
    (5, 8, 3, 3, 0, 0),      # odd anchor and length
    (6, 7, 2, 2, 3, 3),      # 2-D tile with odd column anchor
    (7, 5, 1, 3, 1, 3),      # odd everything
])
@pytest.mark.parametrize("p", [8, 17])
def test_m2l_slab_stack_and_folded(rows, cols, row0, halo, col0, col_halo, p):
    rng = np.random.default_rng(rows * 7 + cols + p)
    me_halo = _cplx(rng, (rows + 2 * halo, cols + 2 * col_halo, p))
    kw = dict(col0=col0, col_halo=col_halo)
    (stack, pr, pc), (jstack, jpr, jpc) = _both(
        ex.m2l_slab_stack, jex.m2l_slab_stack, me_halo, p, row0, halo, **kw)
    assert (pr, pc) == (jpr, jpc)
    np.testing.assert_array_equal(stack.numpy(), np.asarray(jstack))
    level = 5
    le, jle = _both(ex.m2l_folded, jex.m2l_folded, me_halo, level, p,
                    row0=row0, halo=halo, **kw)
    assert le.shape == (rows, cols, p)
    assert _rel(le.numpy(), jle) < TOL


@pytest.mark.parametrize("level,p", [(2, 8), (3, 17), (4, 8)])
def test_m2l_folded_against_masked40(level, p):
    rng = np.random.default_rng(level * p)
    me = _cplx(rng, (1 << level, 1 << level, p))
    folded = ops.m2l_apply(torch.as_tensor(me), level, p).numpy()
    masked = ex.m2l_masked40(torch.as_tensor(me), level, p).numpy()
    assert _rel(folded, masked) < TOL
    assert _rel(masked, jex.m2l_masked40(jnp.asarray(me), level, p)) < TOL
    assert _rel(folded, jex.m2l_reference(jnp.asarray(me), level, p)) < TOL


def test_m2l_slab_stack_rejects_odd_full_width():
    me_halo = torch.zeros((8, 7, 4), dtype=torch.complex64)
    with pytest.raises(ValueError, match="even"):
        ex.m2l_slab_stack(me_halo, 4, 0, 2)


def test_device_operators_cached_once():
    a = ex.device_operator(ex.m2m_operator, 6, torch.device("cpu"))
    b = ex.device_operator(ex.m2m_operator, 6, torch.device("cpu"))
    assert a is b and a.dtype == torch.complex64
    np.testing.assert_array_equal(a.numpy(), ex.m2m_operator(6).astype(np.complex64))
