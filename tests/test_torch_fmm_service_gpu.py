"""The FMM service on the card: a small engine on the CUDA card against the
same engine on the CPU, with the exact launches of each bucket — one P2P
launch of the bucket's mode and one M2L launch per level 2..L, whatever
the bucket's size — and a session's steps.  Each test decides inside
itself whether a card exists; they import no jax.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import m2l, ops, p2p
from repro_torch.serve import fmm_service as svc

SIGMA = 0.02


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _counts():
    return ({k: v for k, v in p2p.LAUNCHES_BY_MODE.items() if v}, m2l.LAUNCHES)


def _zero():
    p2p.LAUNCHES = m2l.LAUNCHES = 0
    for k in p2p.LAUNCHES_BY_MODE:
        p2p.LAUNCHES_BY_MODE[k] = 0


# (equation, with probes, jobs): each bucket drained alone
BUCKETS = [("vortex", False, 3), ("vortex", False, 8), ("laplace", False, 2),
           ("laplace", True, 4), ("tracer", True, 3)]


@pytest.mark.gpu
@pytest.mark.parametrize("equation,probes,jobs", BUCKETS)
def test_bucket_on_the_card_matches_the_cpu_with_exact_launches(cuda, equation,
                                                                probes, jobs):
    rng = np.random.default_rng(len(equation) * 10 + jobs)
    tgt = rng.uniform(0.1, 0.9, size=(300, 2)) if probes else None
    pos = rng.uniform(0.05, 0.95, size=(1500, 2))   # one layout: one bucket
    specs = [(pos, rng.normal(size=1500)) for _ in range(jobs)]
    outs = {}
    for dev in ("cpu", cuda):
        engine = svc.FmmServiceEngine(device=dev)
        jids = [engine.submit(svc.FmmJob(positions=pos, strength=q, equation=equation,
                                         targets=tgt, p=12, sigma=SIGMA))
                for pos, q in specs]
        bucket = engine.queue[0].bucket
        assert {r.bucket for r in engine.queue} == {bucket}
        _zero()
        ops.PLAIN_CALLS = 0
        engine.drain()
        if dev != "cpu":
            torch.cuda.synchronize()
            mode = {"vortex": "base", "tracer": "base", "laplace": "laplace"}[equation]
            mode += "_passive" if probes else ""
            assert _counts() == ({mode: 1}, bucket.level - 1)
            assert ops.PLAIN_CALLS == 0
        assert engine.counters["batches"] == 1
        outs[str(dev)] = [engine.result(j).out for j in jids]
    for got, want in zip(outs[str(cuda)], outs["cpu"]):
        assert got.shape == want.shape
        assert _rel(got, want) < 1e-5


def _wide_jobs():
    """``test_torch_fmm_service.wide_jobs``: a clustered job (bucket slots
    512), a job at p = 40, an ordinary job (no jax here, so a copy)."""
    rng = np.random.default_rng(0)
    pos = np.vstack([0.5 + 0.0625 * rng.random((400, 2)),
                     [[0.05, 0.05], [0.95, 0.95]]])
    clustered = dict(positions=pos, strength=rng.normal(size=402), sigma=1e-2)
    rng = np.random.default_rng(1)
    deep = dict(positions=rng.uniform(size=(2000, 2)), strength=rng.normal(size=2000),
                p=40, sigma=1e-2)
    rng = np.random.default_rng(2)
    plain = dict(positions=rng.uniform(0.1, 0.9, size=(220, 2)),
                 strength=rng.normal(size=220), sigma=1e-2)
    return [clustered, deep, plain]


@pytest.mark.gpu
def test_jobs_past_the_kernels_first_limits_are_served_in_one_drain(cuda):
    """The ROADMAP Queue 3 pin: the clustered job (512 slots), the p = 40 job
    and an ordinary job in one drain on the card.  All three return, through
    the kernels (one P2P launch a bucket, L - 1 M2L, no plain call), each
    within 1e-5 of the same engine on the CPU (which the CPU tests hold to
    the reference engine)."""
    outs = {}
    for dev in ("cpu", cuda):
        engine = svc.FmmServiceEngine(device=dev)
        jids = [engine.submit(svc.FmmJob(**kw)) for kw in _wide_jobs()]
        buckets = [r.bucket for r in engine.queue]
        assert [(b.level, b.slots, b.p) for b in buckets] == \
            [(3, 512, 12), (4, 32, 40), (2, 32, 12)]
        _zero()
        ops.PLAIN_CALLS = 0
        engine.drain()
        assert not engine.queue and engine.counters["batches"] == 3
        if dev != "cpu":
            torch.cuda.synchronize()
            assert _counts() == ({"base": 3}, sum(b.level - 1 for b in buckets))
            assert ops.PLAIN_CALLS == 0
        outs[str(dev)] = [engine.result(j).out for j in jids]
    for got, want in zip(outs[str(cuda)], outs["cpu"]):
        assert got.shape == want.shape and np.isfinite(got).all()
        assert _rel(got, want) < 1e-5


@pytest.mark.gpu
def test_session_on_the_card_matches_the_cpu(cuda):
    """A streamed session: 2 P2P and 2 (L - 1) M2L launches a step on the
    card, positions within the stepper tests' 1e-6 of the CPU engine's."""
    rng = np.random.default_rng(5)
    pos, gam = rng.uniform(0.3, 0.7, size=(400, 2)), 0.1 * rng.normal(size=400)
    finals = {}
    for dev in ("cpu", cuda):
        engine = svc.FmmServiceEngine(device=dev)
        sid = engine.submit(svc.FmmJob(positions=pos, strength=gam, steps=3, p=8,
                                       dt=1e-3, sigma=SIGMA))
        level = engine.session(sid).stepper.params.level
        _zero()
        seen = [i for i, _, _ in engine.session(sid).stream(3)]
        assert seen == [0, 1, 2]
        if dev != "cpu":
            assert _counts() == ({"base": 6}, 6 * (level - 1))
        finals[str(dev)] = engine.session(sid).particles()[0]
    np.testing.assert_allclose(finals[str(cuda)], finals["cpu"], rtol=0, atol=1e-6)


@pytest.mark.gpu
def test_sharded_lane_on_a_mesh_of_one_on_the_card(cuda):
    """The sharded lane on a one-rank mesh: ``kernel_launches(plan)``
    launches, the result within 1e-5 of the batched lane's."""
    from repro_torch.core import parallel_fmm as pf
    from repro_torch.core.cost_model import ModelParams
    from repro_torch.core.plan import plan_from_counts
    from repro_torch.launch.mesh import make_local_mesh
    rng = np.random.default_rng(6)
    pos, q = rng.uniform(0.05, 0.95, size=(3000, 2)), rng.normal(size=3000)
    job = svc.FmmJob(positions=pos, strength=q, p=12, sigma=SIGMA, level=5)
    sharded = svc.FmmServiceEngine(mesh=make_local_mesh(device=cuda),
                                   budget=svc.ServiceBudget(shard_threshold_flops=0.0))
    jid = sharded.submit(job)
    rec = sharded.queue[0]
    assert rec.price.lane == "sharded"
    params = ModelParams(level=5, cut=4, p=12, slots=rec.bucket.slots, nout=1)
    plan = plan_from_counts(svc._leaf_counts(pos, 5), params, 1, method="model")
    _zero()
    sharded.drain()
    torch.cuda.synchronize()
    want = pf.kernel_launches(plan)
    assert _counts() == ({"base": want["p2p"]}, want["m2l"])
    batched = svc.FmmServiceEngine(device=cuda)
    bid = batched.submit(job)
    batched.drain()
    assert _rel(sharded.result(jid).out, batched.result(bid).out) < 1e-5
