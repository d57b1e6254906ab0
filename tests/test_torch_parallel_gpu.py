"""The port's sharded driver on the CUDA card: 2 and 4 gloo ranks sharing
``cuda:0`` at level 6, against the serial kernel path, and the rim strips'
shapes through each kernel against its plain version.

Imports no jax, so ``pytest -m gpu`` runs it where jax is absent; the
cases decide inside the test whether a card exists.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import expansions as ex
from repro_torch.core import fmm
from repro_torch.core import parallel_fmm as pf
from repro_torch.core.plan import BlockPlan, uniform_plan
from repro_torch.core.quadtree import build_tree
from repro_torch.launch.mesh import make_local_mesh, spawn_world

LEVEL, P, SIGMA, N = 6, 12, 0.01, 20000
TOL = 1e-5
PLANS = {2: uniform_plan(LEVEL, 2),
         4: BlockPlan(LEVEL, (0, 28), (28, 36), (0, 36), (36, 28))}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _tree(device):
    rng = np.random.default_rng(0)
    pos = rng.uniform(0.02, 0.98, size=(N, 2))
    return build_tree(pos, rng.normal(size=N), level=LEVEL, sigma=SIGMA,
                      device=device)[0]


def _rank(mesh):
    from repro_torch.kernels import m2l, ops, p2p
    tree, plan = _tree(mesh.device), PLANS[mesh.size]
    out = {}
    for overlap in (True, False):
        for pipeline in (True, False):
            torch.cuda.synchronize()
            p2p.LAUNCHES = m2l.LAUNCHES = ops.PLAIN_CALLS = 0
            w, h = pf.parallel_fmm_velocity(tree, P, mesh, plan, overlap=overlap,
                                            pipeline=pipeline, with_health=True)
            torch.cuda.synchronize()
            out[overlap, pipeline] = {
                "w": w.cpu().numpy(), "health": h.cpu().numpy(),
                "launches": {"p2p": p2p.LAUNCHES, "m2l": m2l.LAUNCHES},
                "plain": ops.PLAIN_CALLS}
    out["staged_bytes"] = mesh.wire.staged_bytes
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("world", [2, 4])
def test_sharded_matches_the_serial_kernel_path_on_the_card(cuda, world):
    serial = fmm.fmm_velocity(_tree(cuda), P).cpu().numpy()
    ranks = spawn_world(_rank, world, device="cuda", timeout_s=300)
    plan = PLANS[world]
    for r in ranks:
        assert r["staged_bytes"] > 0
        for (overlap, pipeline), got in ((k, v) for k, v in r.items()
                                         if isinstance(k, tuple)):
            assert got["launches"] == pf.kernel_launches(plan, overlap)
            assert got["plain"] == 0 and not got["health"].any()
            err = np.linalg.norm(got["w"] - serial) / np.linalg.norm(serial)
            assert err < TOL, (overlap, pipeline, err)
            np.testing.assert_array_equal(got["w"], ranks[0][overlap, pipeline]["w"])
        for overlap in (True, False):
            np.testing.assert_array_equal(r[overlap, True]["w"], r[overlap, False]["w"])


@pytest.mark.gpu
def test_rim_strips_match_the_plain_versions_on_the_card(cuda):
    """The interior and rim shapes of a tile through each kernel, against
    its plain version on the same card tensors."""
    from repro_torch.kernels import m2l, ops, p2p
    tree = _tree(cuda)
    mesh = make_local_mesh(device=cuda)
    n = tree.nside
    packed = pf._pack_particles(tree.z, tree.q, tree.mask)
    zb, qb, mb = pf._unpack_particles(pf._tile_halo(packed, 1, n, n, mesh,
                                                    (1, 1)).wait())
    me = fmm.upward_sweep(tree, P)[LEVEL]
    meb = pf._tile_halo(me, ex.M2L_HALO, n, n, mesh, (1, 1)).wait()
    w = ex.M2L_HALO
    # strips through the middle (the edge boxes hold no particle), cut at a
    # row offset inside the buffer, as the driver cuts its bottom rims
    mid = n // 2
    cuts = {"row": (slice(mid, mid + 3), slice(None)),
            "col": (slice(None), slice(mid, mid + 3)),
            "interior": (slice(None), slice(None))}
    for name, (rs, cs) in cuts.items():
        z, q, m = (fmm._fresh(a[rs, cs]) for a in (zb, qb, mb))
        got = p2p.p2p_cuda(z, q, m, SIGMA)
        want = p2p.p2p_plain(z, q, m, SIGMA)
        assert float(want.abs().max()) > 0, ("p2p", name)
        err = float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))
        assert err < TOL, ("p2p", name, err)
    m2l_cuts = {"row": (slice(mid, mid + 3 * w), slice(None)),
                "col": (slice(None), slice(mid, mid + 3 * w)),
                "interior": (slice(None), slice(None))}
    for name, (rs, cs) in m2l_cuts.items():
        strip = fmm._fresh(meb[rs, cs])
        got = ops.m2l_apply_slab(strip, LEVEL, P, halo=w, col_halo=w)
        want = ex.m2l_folded(strip, LEVEL, P, halo=w, col_halo=w,
                             op=ops.folded_operator(fmm.eqs.VORTEX, P, LEVEL, cuda),
                             scale=fmm.eqs.VORTEX.m2l_scale(LEVEL))
        err = float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))
        assert err < TOL, ("m2l", name, err)
    assert m2l.LAUNCHES > 0 and p2p.LAUNCHES > 0
