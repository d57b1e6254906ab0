"""The port's host-side planner (``core/{cost_model,partition,plan}.py``)
against the reference package's on the same counts.

Both are numpy with the same arithmetic, so every estimate, partition,
plan bound, score and choice must be equal, not close.  The cases are
those of ``tests/test_cost_model.py`` and the serial ones of
``tests/test_partition.py``.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import cost_model as jcm
from repro.core import partition as jpt
from repro.core import plan as jplan
from repro_torch.core import cost_model as cm
from repro_torch.core import partition as pt
from repro_torch.core import plan
from repro_torch.core.quadtree import build_tree
from repro_torch.core.vortex import lamb_oseen_particles


def _uniform_counts(level, per_box=2):
    n = 1 << level
    return np.full((n, n), per_box, dtype=np.int64)


def _gaussian_counts(level, total=120_000, seed=0, sigma=0.15):
    """An off-centre cluster over a uniform background, as in
    ``tests/test_cost_model.py``."""
    rng = np.random.default_rng(seed)
    n = 1 << level
    n_cluster = int(total * 0.7)
    cluster = rng.normal((0.3, 0.62), sigma, size=(n_cluster, 2))
    background = rng.uniform(0, 1, size=(total - n_cluster, 2))
    pos = np.concatenate([cluster, background]).clip(0.001, 0.999)
    ij = (pos * n).astype(int)
    counts = np.zeros((n, n), dtype=np.int64)
    np.add.at(counts, (ij[:, 1], ij[:, 0]), 1)
    return counts


def _lamb_oseen_counts(level, m_side=120):
    pos, _, _ = lamb_oseen_particles(m_side)
    n = 1 << level
    ij = np.clip((pos * n).astype(int), 0, n - 1)
    counts = np.zeros((n, n), dtype=np.int64)
    np.add.at(counts, (ij[:, 1], ij[:, 0]), 1)
    return counts


COUNTS = {
    "uniform": lambda level: _uniform_counts(level),
    "gaussian": lambda level: _gaussian_counts(level, seed=3),
    "lamb_oseen": lambda level: _lamb_oseen_counts(level, m_side=160),
}


def _params(mod, level=6, cut=3, p=17, slots=4, nout=1):
    return mod.ModelParams(level=level, cut=cut, p=p, slots=slots, nout=nout)


def _same(a, b):
    """Exact equality of nested results (dicts, sequences, arrays, plans)."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__
        _same(dataclasses.asdict(a), dataclasses.asdict(b))
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _plan_fields(p):
    return type(p).__name__, dataclasses.asdict(p)


# ---------------------------------------------------------------------------
# Cost model (paper §5, Eqs 11-15)
# ---------------------------------------------------------------------------


def test_constants_match_reference():
    for name in ("D", "N_CHILD", "N_IL", "N_ND", "PARTICLE_BYTES",
                 "ARROW_BYTES", "M2L_HALO_ROWS", "P2P_HALO_ROWS"):
        assert getattr(cm, name) == getattr(jcm, name), name


@pytest.mark.parametrize("kind", sorted(COUNTS))
@pytest.mark.parametrize("nout", [1, 2])
def test_work_estimates_match_reference(kind, nout):
    counts = COUNTS[kind](6)
    a, b = _params(cm, nout=nout), _params(jcm, nout=nout)
    _same(cm.work_leaf(counts.astype(float), 17, nout=nout),
          jcm.work_leaf(counts.astype(float), 17, nout=nout))
    _same(cm.neighbor_count_sum(counts), jcm.neighbor_count_sum(counts))
    _same(cm.work_subtree(counts, a), jcm.work_subtree(counts, b))
    assert cm.work_active_total(counts, a) == jcm.work_active_total(counts, b)
    assert cm.work_padded_total(counts, a) == jcm.work_padded_total(counts, b)
    assert cm.work_nonleaf(17) == jcm.work_nonleaf(17) == 17 * 17 * (2 * 4 + 27)


@pytest.mark.parametrize("level,cut,p", [(6, 3, 17), (10, 4, 17), (7, 4, 12)])
def test_comm_and_memory_estimates_match_reference(level, cut, p):
    a, b = _params(cm, level, cut, p), _params(jcm, level, cut, p)
    for fn in ("comm_lateral", "comm_diagonal", "comm_root_tree",
               "work_root_tree"):
        assert getattr(cm, fn)(a) == getattr(jcm, fn)(b), fn
    _same(cm.comm_halo_dense(a), jcm.comm_halo_dense(b))
    _same(cm.comm_halo_dense(a, slots=8), jcm.comm_halo_dense(b, slots=8))
    assert cm.comm_particles_boundary(a, 37.5) == jcm.comm_particles_boundary(b, 37.5)
    leaf = np.array([16.0, 64.0, 256.0])
    _same(cm.work_upward(a, leaf), jcm.work_upward(b, leaf))
    _same(cm.comm_overlap_effective(np.array([1e3, 5e4]), np.array([2e4, 1e3]), a),
          jcm.comm_overlap_effective(np.array([1e3, 5e4]), np.array([2e4, 1e3]), b))
    _same(cm.memory_serial(a, 765_625), jcm.memory_serial(b, 765_625))
    _same(cm.memory_parallel(a, 64, 256, 32), jcm.memory_parallel(b, 64, 256, 32))
    assert cm.total_boxes(level) == jcm.total_boxes(level)
    assert cm.alpha_comm(p) == jcm.alpha_comm(p)
    assert cm.greengard_gropp_time(765_625, 64, 4 ** level) == \
        jcm.greengard_gropp_time(765_625, 64, 4 ** level)


def test_batch_pricing_and_digest_match_reference():
    _same(cm.batch_padding_stats(3.5, 3, 8), jcm.batch_padding_stats(3.5, 3, 8))
    x = np.arange(12.0).reshape(3, 4)
    assert cm.array_digest(x, x.astype(np.int32)) == \
        jcm.array_digest(x, x.astype(np.int32))


# ---------------------------------------------------------------------------
# Partitioner (paper §4)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", sorted(COUNTS))
@pytest.mark.parametrize("method", ["uniform-sfc", "sfc", "model"])
@pytest.mark.parametrize("nparts", [4, 6, 16])
def test_partitions_match_reference(kind, method, nparts):
    level, cut = (7, 4) if kind == "gaussian" else (6, 3)
    counts = COUNTS[kind](level)
    g = pt.build_subtree_graph(counts, _params(cm, level, cut))
    jg = jpt.build_subtree_graph(counts, _params(jcm, level, cut))
    _same(g.vertex_weight, jg.vertex_weight)
    _same(g.adjacency, jg.adjacency)
    a = pt.partition(g, nparts, method=method)
    _same(a, jpt.partition(jg, nparts, method=method))
    _same(pt.partition_stats(g, a, nparts), jpt.partition_stats(jg, a, nparts))
    assert pt.load_balance_metric(g, a, nparts) == jpt.load_balance_metric(jg, a, nparts)


def test_rebalance_and_measured_rates_match_reference():
    counts = _gaussian_counts(6, seed=5)
    g = pt.build_subtree_graph(counts, _params(cm))
    jg = jpt.build_subtree_graph(counts, _params(jcm))
    a0 = pt.partition(g, 4, method="model")
    times = g.part_loads(a0, 4)
    times[0] *= 3.0
    a1 = pt.rebalance(g, a0, 4, times)
    _same(a1, jpt.rebalance(jg, a0, 4, times))
    assert g.part_loads(a1, 4)[0] < g.part_loads(a0, 4)[0] * 0.75
    loads, t = np.array([10.0, 0.0, 20.0]), np.array([10.0, 5.0, 40.0])
    _same(pt.measured_rates(loads, t), jpt.measured_rates(loads, t))
    _same(pt.morton_order(8), jpt.morton_order(8))


# ---------------------------------------------------------------------------
# Execution plans (SlabPlan, BlockPlan), scores and the autotuner
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", ["uniform", "sfc", "model"])
@pytest.mark.parametrize("nparts", [2, 3, 4, 7])
def test_slab_plans_match_reference(method, nparts):
    counts = _lamb_oseen_counts(5, m_side=100)
    a, b = _params(cm, 5, 3, 12), _params(jcm, 5, 3, 12)
    got = plan.plan_from_counts(counts, a, nparts, method=method)
    want = jplan.plan_from_counts(counts, b, nparts, method=method)
    assert _plan_fields(got) == _plan_fields(want)
    _same(got.gather_index(), want.gather_index())
    _same(got.scatter_index(), want.scatter_index())
    _same(got.owner_of_row(), want.owner_of_row())
    _same(plan.plan_loads(got, counts, a), jplan.plan_loads(want, counts, b))
    _same(plan.plan_stats(got, counts, a), jplan.plan_stats(want, counts, b))
    _same(plan.halo_volume(got, a), jplan.halo_volume(want, b))
    _same(plan.assignment_from_plan(got, 3), jplan.assignment_from_plan(want, 3))


@pytest.mark.parametrize("grid", [(2, 2), (2, 3), (4, 2), (3, 3)])
@pytest.mark.parametrize("method", ["uniform", "model"])
def test_block_plans_match_reference(grid, method):
    counts = _lamb_oseen_counts(6, m_side=160)
    a, b = _params(cm, 6, 4, 12, 8), _params(jcm, 6, 4, 12, 8)
    got = plan.block_plan_from_counts(counts, a, grid, method=method)
    want = jplan.block_plan_from_counts(counts, b, grid, method=method)
    assert _plan_fields(got) == _plan_fields(want)
    _same(got.gather_index(), want.gather_index())
    _same(got.scatter_index(), want.scatter_index())
    _same(got.tile_maps(0), want.tile_maps(0))
    _same(got.rim_owners(), want.rim_owners())
    _same(plan.plan_stats(got, counts, a), jplan.plan_stats(want, counts, b))
    for executed in (False, True):
        _same(plan.halo_volume(got, a, executed=executed),
              jplan.halo_volume(want, b, executed=executed))
    for overlap in (False, True):
        assert plan.plan_score(got, counts, a, overlap=overlap) == \
            jplan.plan_score(want, counts, b, overlap=overlap)
    _same(plan.assignment_from_plan(got, 4), jplan.assignment_from_plan(want, 4))


def test_plan_bounds_are_checked_like_the_reference():
    for mod in (plan, jplan):
        with pytest.raises(ValueError):
            mod.SlabPlan(level=4, row0=(0, 8), rows=(8, 6))
        with pytest.raises(ValueError):
            mod.SlabPlan(level=4, row0=(0, 5), rows=(5, 11))
        with pytest.raises(ValueError):
            mod.BlockPlan(level=4, row0=(0,), rows=(16,), col0=(0, 5), cols=(5, 11))
        with pytest.raises(ValueError):
            mod.uniform_plan(level=2, nparts=3)
    assert plan.uniform_plan(5, 4) == plan.uniform_plan(5, 4)
    assert _plan_fields(plan.uniform_block_plan(5, (2, 3))) == \
        _plan_fields(jplan.uniform_block_plan(5, (2, 3)))


@pytest.mark.parametrize("prev", ["slab", "block"])
def test_replan_matches_reference(prev):
    counts = _lamb_oseen_counts(6, m_side=160)
    a, b = _params(cm, 6, 4, 12, 8), _params(jcm, 6, 4, 12, 8)
    if prev == "slab":
        p0 = plan.plan_from_counts(counts, a, 6, method="model")
        j0 = jplan.plan_from_counts(counts, b, 6, method="model")
    else:
        p0 = plan.block_plan_from_counts(counts, a, (2, 3), method="model")
        j0 = jplan.block_plan_from_counts(counts, b, (2, 3), method="model")
    times = plan.plan_loads(p0, counts, a)
    times[1] *= 3.0
    for kw in ({}, {"grid": (2, 3)}, {"grid": "auto"}):
        got = plan.replan(counts, a, 6, prev_plan=p0, measured_times=times, **kw)
        want = jplan.replan(counts, b, 6, prev_plan=j0, measured_times=times, **kw)
        assert _plan_fields(got) == _plan_fields(want), kw
    _same(plan.measured_row_scale(p0, counts, a, times),
          jplan.measured_row_scale(j0, counts, b, times))


@pytest.mark.parametrize("kind", sorted(COUNTS))
@pytest.mark.parametrize("nparts", [4, 6, 8, 16])
def test_autotune_plan_choice_matches_reference(kind, nparts):
    counts = COUNTS[kind](6)
    a, b = _params(cm, 6, 4, 17, 8), _params(jcm, 6, 4, 17, 8)
    got = plan.autotune_plan(counts, a, nparts)
    want = jplan.autotune_plan(counts, b, nparts)
    assert _plan_fields(got) == _plan_fields(want)
    assert plan.plan_score(got, counts, a) == jplan.plan_score(want, counts, b)
    assert plan.candidate_grids(nparts) == jplan.candidate_grids(nparts)


def test_cell_loads_grow_with_equation_arity():
    """The work model reads the equation's arity (``ModelParams.nout``),
    as ``tests/test_equations.py`` pins for the reference."""
    pos, gamma, sigma = lamb_oseen_particles(80)
    _, index = build_tree(pos, gamma, 5, sigma, device="cpu")
    w1 = plan.cell_loads(index.counts, _params(cm, 5, 4, 12, 8, nout=1))
    w2 = plan.cell_loads(index.counts, _params(cm, 5, 4, 12, 8, nout=2))
    assert (w2 > w1).any() and (w2 >= w1).all()
    _same(w2, jplan.cell_loads(index.counts, _params(jcm, 5, 4, 12, 8, nout=2)))
    _same(plan.row_loads(index.counts, _params(cm, 5, 4, 12, 8, nout=2)),
          jplan.row_loads(index.counts, _params(jcm, 5, 4, 12, 8, nout=2)))
