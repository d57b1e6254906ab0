"""The port's FMM service against the reference's (``src/repro/serve/
fmm_service.py``) on the same job streams, on the CPU.

Pricing, bucketing and admission are host arithmetic that both engines
share line for line, so prices, bucket keys, admission decisions, counters
and cache counts must be EQUAL.  One-shot outputs are f32 FMM evaluations
through different frameworks: within 1e-5 relative of the reference's
batched lane (``batched_fmm_eval[_targets]``, ``vmap`` of its jnp route),
and probe jobs within 1e-4 of the f64 ``direct_sum`` (p = 12).  Session
positions hold the stepper tests' 1e-6 absolute; a session restored from
the reference's checkpoint starts from its tree bit for bit.
"""
import dataclasses
import threading

import jax
import numpy as np
import pytest
import torch

from repro.core import quadtree as jqt
from repro.serve import fmm_service as rsvc
from repro_torch.core import equations as eqs
from repro_torch.core.fmm import fmm_evaluate
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.serve import fmm_service as svc

SIGMA = 0.02
CPU = dict(device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite's parallel workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sources(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.1, 0.9, size=(n, 2)), rng.normal(size=n)


def _engines(**kw):
    """The reference's engine and the port's on the CPU, same settings."""
    return rsvc.FmmServiceEngine(**kw), svc.FmmServiceEngine(**kw, **CPU)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _counted(stats):
    """The stats that are pure host arithmetic (latencies are clocks;
    ``jit_entries`` is a process-wide count in both packages)."""
    return {k: v for k, v in stats.items() if k not in ("latency", "jit_entries")}


# ---------------------------------------------------------------------------
# Pricing, buckets, admission: equal to the reference
# ---------------------------------------------------------------------------

_pos, _q = _sources(220, seed=1)
_tgt = np.random.default_rng(2).uniform(0.15, 0.85, size=(60, 2))
JOBS = {
    "vortex_auto": dict(positions=_pos, strength=_q, sigma=SIGMA),
    "vortex_explicit": dict(positions=_pos, strength=_q, level=4, p=7, sigma=SIGMA),
    "laplace_probes": dict(positions=_pos, strength=_q, equation="laplace",
                           targets=_tgt, p=8, sigma=SIGMA),
    "tracer": dict(positions=_pos, strength=_q, equation="tracer", targets=_tgt,
                   sigma=SIGMA),
    "session": dict(positions=_pos, strength=0.1 * _q, steps=4, p=6, dt=1e-3,
                    sigma=SIGMA),
}


@pytest.mark.parametrize("kind", sorted(JOBS))
def test_price_and_bucket_equal_the_reference(kind):
    ref, port = _engines()
    rid = ref.submit(rsvc.FmmJob(**JOBS[kind]))
    pid = port.submit(svc.FmmJob(**JOBS[kind]))
    assert rid == pid
    if JOBS[kind].get("steps"):
        want, got = ref.session(rid).price, port.session(pid).price
        assert got.lane == "session" and got.steps == 4
        # the session opened on the port's stepper at the priced sizes'
        # rules: the same tree the reference's stepper built
        rs, ps = ref.session(rid).stepper, port.session(pid).stepper
        assert dataclasses.asdict(ps.params) == dataclasses.asdict(rs.params)
    else:
        want, got = ref.queue[0].price, port.queue[0].price
        assert dataclasses.asdict(port.queue[0].bucket) == \
            dataclasses.asdict(ref.queue[0].bucket)
        assert port.queue[0].tree_key == ref.queue[0].tree_key
        assert port.queue[0].tgt_key == ref.queue[0].tgt_key
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_sharded_price_equals_the_reference_on_a_mesh_of_one():
    """With a mesh, a job at the shard threshold takes the sharded lane and
    its price carries the plan's communication cost: a one-device mesh in
    the reference, a one-rank ``RankMesh`` here."""
    from jax.sharding import Mesh
    ref = rsvc.FmmServiceEngine(mesh=Mesh(np.array(jax.devices()[:1]), ("data",)),
                                budget=rsvc.ServiceBudget(shard_threshold_flops=0.0))
    port = svc.FmmServiceEngine(mesh=make_local_mesh(**CPU),
                                budget=svc.ServiceBudget(shard_threshold_flops=0.0))
    assert ref.nparts == port.nparts == 1
    for kind in ("vortex_auto", "laplace_probes"):
        ref.submit(rsvc.FmmJob(**JOBS[kind]))
        port.submit(svc.FmmJob(**JOBS[kind]))
        want, got = ref.queue[-1].price, port.queue[-1].price
        assert got.lane == "sharded"
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert port.cache.stats() == ref.cache.stats()


def test_rejection_carries_the_reference_price():
    ref, port = _engines()
    ref.budget = rsvc.ServiceBudget(max_job_flops=1.0)
    port.budget = svc.ServiceBudget(max_job_flops=1.0)
    prices = []
    for mod, engine in ((rsvc, ref), (svc, port)):
        with pytest.raises(mod.JobRejected, match="exceeds max_job_flops") as ei:
            engine.submit(mod.FmmJob(**JOBS["vortex_auto"]))
        prices.append(dataclasses.asdict(ei.value.price))
        assert engine.cache.stats() == {"entries": 0, "hits": 0, "misses": 0}
        assert engine.results == {}
    assert prices[0] == prices[1]
    assert _counted(port.stats()) == _counted(ref.stats())


def test_backlog_defers_promotes_and_counts_as_the_reference():
    """The reference's drill: max_queue_flops at 1.5 jobs' worth defers the
    later jobs and promotes them one drain pass at a time; the counters,
    the queue's shape at each point and the cache counts are equal."""
    ref, port = _engines()
    pos, q = _sources(60, seed=1)
    shapes = []
    for mod, engine in ((rsvc, ref), (svc, port)):
        first = engine.submit(mod.FmmJob(positions=pos, strength=q, p=4, sigma=SIGMA))
        per_job = engine.queue[0].price.total_flops
        engine.budget = mod.ServiceBudget(max_queue_flops=1.5 * per_job)
        later = [engine.submit(mod.FmmJob(positions=pos, strength=q * (i + 2), p=4,
                                          sigma=SIGMA)) for i in range(2)]
        seen = [(len(engine.queue), len(engine.deferred))]
        while engine.queue or engine.deferred:
            engine.run_once()
            seen.append((len(engine.queue), len(engine.deferred)))
        shapes.append(seen)
        assert set(engine.results) == {first, *later}
    assert shapes[0] == shapes[1] == [(1, 2), (1, 1), (1, 0), (0, 0)]
    assert _counted(port.stats()) == _counted(ref.stats())
    assert port.counters["deferred"] == port.counters["promoted"] == 2


def test_tree_cache_hits_and_misses_equal_the_reference():
    ref, port = _engines()
    pos, q = _sources(120, seed=30)
    job = dict(positions=pos, strength=q, p=6, sigma=SIGMA)
    stream = [job, job, {**job, "strength": q + 1.0},
              {**job, "equation": "laplace", "p": 6}]
    for kw in stream:
        for mod, engine in ((rsvc, ref), (svc, port)):
            engine.submit(mod.FmmJob(**kw))
            engine.drain()
        assert port.cache.stats() == ref.cache.stats()
    assert port.cache.stats() == {"entries": 3, "hits": 1, "misses": 3}


def test_stats_keys_equal_the_reference():
    ref, port = _engines()
    pos, q = _sources(110, seed=34)
    for mod, engine in ((rsvc, ref), (svc, port)):
        engine.submit(mod.FmmJob(positions=pos, strength=q, p=6, sigma=SIGMA))
        engine.drain()
    rs, ps = ref.stats(), port.stats()
    assert set(ps) == set(rs)
    assert set(ps["latency"]) == set(rs["latency"]) == {"batched"}
    assert set(ps["latency"]["batched"]) == set(rs["latency"]["batched"])
    assert _counted(ps) == _counted(rs)
    assert ps["jit_entries"] == svc.batched_cache_entries()


def test_artifact_cache_counters():
    c = svc.ArtifactCache()
    assert c.get("k", lambda: 41) == 41
    assert c.get("k", lambda: 42) == 41
    assert "k" in c and len(c) == 1
    assert c.stats() == {"entries": 1, "hits": 1, "misses": 1}
    c.clear()
    assert len(c) == 0 and c.stats()["hits"] == 1


# ---------------------------------------------------------------------------
# The batched lane: the reference's results
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def served():
    """One mixed stream through both engines: two vortex jobs of one layout
    (one bucket, capacity 2), two Laplace probe jobs and a tracer job."""
    src, q = _sources(160, seed=3)
    tgt = np.random.default_rng(4).uniform(0.15, 0.85, size=(48, 2))
    jobs = [dict(positions=src, strength=q, p=8, sigma=SIGMA),
            dict(positions=src, strength=-2.0 * q, p=8, sigma=SIGMA),
            dict(positions=src, strength=q, equation="laplace", targets=tgt, p=12,
                 sigma=SIGMA),
            dict(positions=src, strength=0.5 * q, equation="laplace", targets=tgt,
                 p=12, sigma=SIGMA),
            dict(positions=src, strength=q, equation="tracer", targets=tgt, p=12,
                 sigma=SIGMA)]
    ref, port = _engines()
    rids = [ref.submit(rsvc.FmmJob(**kw)) for kw in jobs]
    pids = [port.submit(svc.FmmJob(**kw)) for kw in jobs]
    ref.drain()
    port.drain()
    return dict(jobs=jobs, ref=ref, port=port, rids=rids, pids=pids)


def wide_jobs():
    """The jobs the port's card route once refused (ROADMAP Queue 3): 400
    particles clustered in one leaf box plus two far ones (bucket slots
    512), 2,000 uniform ones at p = 40, and an ordinary job."""
    rng = np.random.default_rng(0)
    pos = np.vstack([0.5 + 0.0625 * rng.random((400, 2)),
                     [[0.05, 0.05], [0.95, 0.95]]])
    clustered = dict(positions=pos, strength=rng.normal(size=402), sigma=1e-2)
    rng = np.random.default_rng(1)
    deep = dict(positions=rng.uniform(size=(2000, 2)), strength=rng.normal(size=2000),
                p=40, sigma=1e-2)
    src, q = _sources(220, seed=2)
    return [clustered, deep, dict(positions=src, strength=q, sigma=1e-2)]


WIDE_BUCKETS = [(3, 512, 12), (4, 32, 40), (2, 32, 12)]   # (level, slots, p)


@pytest.fixture(scope="module")
def wide_served():
    """The three jobs of :func:`wide_jobs` through both engines, one drain
    each; buckets and prices read before the drain."""
    jobs = wide_jobs()
    ref, port = _engines()
    rids = [ref.submit(rsvc.FmmJob(**kw)) for kw in jobs]
    pids = [port.submit(svc.FmmJob(**kw)) for kw in jobs]
    seen = [(dataclasses.asdict(r.bucket), dataclasses.asdict(r.price),
             dataclasses.asdict(q.bucket), dataclasses.asdict(q.price))
            for r, q in zip(ref.queue, port.queue)]
    ref.drain()
    port.drain()
    return dict(jobs=jobs, ref=ref, port=port, rids=rids, pids=pids, seen=seen)


@pytest.mark.parametrize("i", range(3))
def test_wide_jobs_price_and_bucket_equal_the_reference(wide_served, i):
    rb, rp, pb, pp = wide_served["seen"][i]
    assert pb == rb and pp == rp
    assert (pb["level"], pb["slots"], pb["p"]) == WIDE_BUCKETS[i]


@pytest.mark.parametrize("i", range(3))
def test_wide_jobs_served_in_one_drain_match_the_reference(wide_served, i):
    """One drain serves all three (three buckets).  The clustered and the
    ordinary job are within 1e-5 of the reference engine.  At p = 40 the
    reference engine's output is NaN (its P2M forms ``zhat**k`` for empty
    slots too, which overflows f32 at this order already at level 4, the
    kept divergence of ``test_p2m_finite_for_empty_slots_at_depth``), so
    the port's is held to the reference's f64 ``direct_sum`` instead."""
    from repro.core import equations as req
    port, ref = wide_served["port"], wide_served["ref"]
    assert port.counters["batches"] == ref.counters["batches"] == 3
    got = port.result(wide_served["pids"][i]).out
    want = np.asarray(ref.result(wide_served["rids"][i]).out)
    assert got.shape == want.shape and np.isfinite(got).all()
    if WIDE_BUCKETS[i][2] == 40:
        assert not np.isfinite(want).any()
        job = wide_served["jobs"][i]
        z = job["positions"][:, 0] + 1j * job["positions"][:, 1]
        want = req.direct_sum(req.VORTEX, z, z, job["strength"], job["sigma"])
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("i", range(5))
def test_batched_results_match_the_reference(served, i):
    r = served["ref"].result(served["rids"][i])
    p = served["port"].result(served["pids"][i])
    assert (p.lane, p.batch_capacity) == (r.lane, r.batch_capacity)
    assert p.out.shape == np.asarray(r.out).shape
    assert _rel(p.out, np.asarray(r.out)) < 1e-5


def test_served_counters_equal_the_reference(served):
    assert _counted(served["port"].stats()) == _counted(served["ref"].stats())
    assert served["port"].counters["batches"] == 3


@pytest.mark.parametrize("i", [2, 3, 4])
def test_probe_jobs_match_direct_sum(served, i):
    kw = served["jobs"][i]
    out = served["port"].result(served["pids"][i]).out
    zt = kw["targets"][:, 0] + 1j * kw["targets"][:, 1]
    zs = kw["positions"][:, 0] + 1j * kw["positions"][:, 1]
    ref = eqs.direct_sum(kw["equation"], zt, zs, kw["strength"], SIGMA)
    if kw["equation"] == "laplace":
        # Re of the potential is branch-cut exact; the field compares whole
        err = max(_rel(out[:, 0].real, ref[:, 0].real), _rel(out[:, 1], ref[:, 1]))
    else:
        err = _rel(out, ref)
    assert err < 1e-4, err


@pytest.mark.parametrize("targets", [False, True])
def test_batched_entry_points_match_the_reference(targets):
    """``batched_fmm_eval[_targets]`` on the reference's own trees (as
    numpy, through ``ensure_device``), padded to capacity 4 by
    ``stack_trees``: the padded rows give 0."""
    rng = np.random.default_rng(9)
    level, slots, p = 3, 16, 8
    eq_name = "tracer" if targets else "vortex"
    jtrees, jtgts = [], []
    for _ in range(3):
        pos = rng.uniform(0.05, 0.95, (200, 2))
        jtrees.append(jqt.build_tree(pos, rng.normal(size=200), level, SIGMA,
                                     slots=slots)[0])
        jtgts.append(jqt.build_tree(rng.uniform(0.05, 0.95, (50, 2)), np.zeros(50),
                                    level, SIGMA, slots=8)[0])
    z, q, m = rsvc.stack_trees(jtrees, 4)
    ptrees = [svc.ensure_device(jqt.Tree(z=np.asarray(t.z), q=np.asarray(t.q),
                                         mask=np.asarray(t.mask), level=level,
                                         sigma=SIGMA), "cpu") for t in jtrees]
    pz, pq, pm = svc.stack_trees(ptrees, 4)
    assert pz.shape == (4, 8, 8, slots) and not bool(pm[3].any())
    from repro.core import equations as jeqs
    if targets:
        tz, _, tm = rsvc.stack_trees(jtgts, 4)
        want = rsvc.batched_fmm_eval_targets(z, q, m, tz, tm, level=level, sigma=SIGMA,
                                             p=p, eq=jeqs.get_equation(eq_name))
        ptz = torch.as_tensor(np.array(tz))
        got = svc.batched_fmm_eval_targets(pz, pq, pm, ptz, torch.as_tensor(np.array(tm)),
                                           level=level, sigma=SIGMA, p=p, eq=eq_name)
    else:
        want = rsvc.batched_fmm_eval(z, q, m, level=level, sigma=SIGMA, p=p,
                                     eq=jeqs.get_equation(eq_name))
        got = svc.batched_fmm_eval(pz, pq, pm, level=level, sigma=SIGMA, p=p,
                                   eq=eq_name)
    assert got.shape == tuple(want.shape)
    assert _rel(got.numpy(), np.asarray(want)) < 1e-5
    assert bool((got[3] == 0).all())


def test_ensure_device_takes_a_reference_tree_as_numpy():
    pos, q = _sources(150, seed=5)
    jt, _ = jqt.build_tree(pos, q, 3, SIGMA, slots=32)
    host = jqt.Tree(z=np.asarray(jt.z), q=np.asarray(jt.q), mask=np.asarray(jt.mask),
                    level=jt.level, sigma=jt.sigma)
    tree = svc.ensure_device(host, "cpu")
    assert all(isinstance(a, torch.Tensor) for a in (tree.z, tree.q, tree.mask))
    assert (tree.z.dtype, tree.mask.dtype) == (torch.complex64, torch.bool)
    from repro.core.fmm import fmm_evaluate as jfmm_evaluate
    want = np.asarray(jfmm_evaluate(rsvc.ensure_device(host), 8))
    assert _rel(fmm_evaluate(tree, 8, **CPU).numpy(), want) < 1e-5


def test_steady_state_adds_no_launch_configuration():
    """Waves of the same layouts and width with fresh strengths run the
    launch configurations the first wave ran."""
    engine = svc.FmmServiceEngine(**CPU)
    pos, q = _sources(150, seed=20)
    rng = np.random.default_rng(21)
    for wave in range(3):
        for _ in range(3):
            engine.submit(svc.FmmJob(positions=pos, strength=rng.normal(size=len(q)),
                                     p=8, sigma=SIGMA))
        engine.drain()
        if wave == 0:
            warm = svc.batched_cache_entries()
            assert ("batched_fmm_eval" in svc.TRACE_ENTRY_POINTS
                    and warm >= 1)
    assert svc.batched_cache_entries() == warm
    assert engine.stats()["jit_entries"] == warm


# ---------------------------------------------------------------------------
# Sessions: the reference's trajectories and checkpoints
# ---------------------------------------------------------------------------

def _session_job(mod, pos, gam, steps=3):
    return mod.FmmJob(positions=pos, strength=gam, steps=steps, p=6, dt=1e-3,
                      sigma=SIGMA)


def test_session_stream_matches_the_reference_stepper():
    """Three prefetched steps: every step yielded, each step's positions
    within 1e-6 of the reference session's, cache hits as the reference's
    (tree and plan misses at open, two hits a step)."""
    pos, q = _sources(150, seed=31)
    ref, port = _engines()
    rid = ref.submit(_session_job(rsvc, pos, 0.1 * q))
    pid = port.submit(_session_job(svc, pos, 0.1 * q))
    want = [p_ for _, p_, _ in ref.session(rid).stream(3, prefetch=False)]
    got = list(port.session(pid).stream(3, prefetch=True))
    assert [i for i, _, _ in got] == [0, 1, 2]
    for (_, p_, rec), w in zip(got, want):
        np.testing.assert_allclose(p_, w, rtol=0, atol=1e-6)
        assert rec.recovered == ""
    assert port.cache.stats() == ref.cache.stats() == \
        {"entries": 2, "hits": 6, "misses": 2}
    assert port.counters["session_steps"] == 3
    assert port.stats()["latency"]["session"]["n"] == 3


def test_restore_session_from_the_reference_checkpoint(tmp_path):
    """The reference's session checkpoints; the port's engine restores it
    (the tree bit for bit), and both continue one step within 1e-6; the
    port's own checkpoint restores bit for bit."""
    pos, q = _sources(120, seed=32)
    ref = rsvc.FmmServiceEngine(session_kwargs={"checkpoint_dir": str(tmp_path / "r")})
    rid = ref.submit(_session_job(rsvc, pos, 0.1 * q, steps=2))
    ref.step_session(rid)
    ref.session(rid).stepper.save_checkpoint()
    ref.session(rid).stepper._ckpt.wait()
    port = svc.FmmServiceEngine(session_kwargs={"checkpoint_dir": str(tmp_path / "p")},
                                **CPU)
    back = port.restore_session(str(tmp_path / "r"))
    st, rst = port.session(back).stepper, ref.session(rid).stepper
    for a, b in ((st.tree.z, rst.tree.z), (st.tree.q, rst.tree.q),
                 (st.tree.mask, rst.tree.mask)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert port.session(back).price.lane == "session"
    port.step_session(back)
    ref.step_session(rid)
    np.testing.assert_allclose(port.session(back).particles()[0],
                               ref.session(rid).particles()[0], rtol=0, atol=1e-6)
    # the port's own: save, restore, both step once, bit for bit
    st.checkpoint_every = 0
    sid = port.submit(_session_job(svc, pos, 0.1 * q, steps=2))
    port.step_session(sid)
    own = port.session(sid).stepper
    own.save_checkpoint()
    own.wait_checkpoint()
    again = port.restore_session(str(tmp_path / "p"))
    port.step_session(sid)
    port.step_session(again)
    a, b = own.tree, port.session(again).stepper.tree
    assert torch.equal(a.z, b.z) and torch.equal(a.q, b.q) and torch.equal(a.mask, b.mask)


def test_stream_reraises_a_worker_exception_and_stops_its_worker():
    pos, q = _sources(90, seed=33)
    engine = svc.FmmServiceEngine(**CPU)
    sid = engine.submit(_session_job(svc, pos, 0.1 * q, steps=4))
    real = engine.step_session
    calls = []

    def flaky(session_id):
        calls.append(session_id)
        if len(calls) == 2:
            raise FloatingPointError("step 2 failed")
        return real(session_id)
    engine.step_session = flaky
    seen = []
    with pytest.raises(FloatingPointError, match="step 2 failed"):
        for i, _, _ in engine.session(sid).stream(4):
            seen.append(i)
    assert seen == [0]
    # a consumer that stops early stops the worker too
    engine.step_session = real
    before = threading.active_count()
    stream = engine.session(sid).stream(4)
    next(stream)
    stream.close()
    assert threading.active_count() == before


def test_engine_refuses_a_device_that_is_not_the_mesh_s():
    with pytest.raises(ValueError, match="mesh"):
        svc.FmmServiceEngine(mesh=make_local_mesh(**CPU), device="meta")


def test_cli_serves_on_cpu(capsys):
    from repro_torch.launch import fmm_serve
    assert fmm_serve.main(["--device", "cpu", "--jobs", "4", "--n", "150",
                           "--steps", "1", "--p", "6"]) == 0
    out = capsys.readouterr().out
    assert "== fmm_serve: 1 rank(s) on cpu" in out
    assert "jit_entries=" in out and "latency[batched]" in out
    assert out.rstrip().endswith("== fmm_serve: OK")
