"""The collective-schedule verifier (src/repro_torch/analysis/schedule.py).

* the schedule log of ``RankMesh`` and the ``DryMesh`` that stands in for
  it;
* the fused P2P exchange's directions on the 2x2 grid and both degenerate
  ones, held to the reference's collective-permute counts (a jax
  subprocess on 4 forced host devices);
* the nine schedule cases of the reference's ``check.py`` verify clean;
* a planted dropped all-gather and a planted mis-shaped send are each
  flagged with a diff naming the rank and the round, and each sanity check
  has a planted violation;
* real ranks (a ``spawn_world`` of 4 CPU ranks over gloo) log exactly the
  schedules the dry simulation gives, event for event.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch.analysis import check as CK
from repro_torch.analysis import schedule as S
from repro_torch.core import parallel_fmm as pf
from repro_torch.core import stepper as stp
from repro_torch.launch.mesh import MeshEvent, make_local_mesh, spawn_world

CPU = torch.device("cpu")
ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def _fused(grid, mesh):
    return CK.fused_exchange(grid, mesh=mesh)


# ---------------------------------------------------------------------------
# the log and the dry mesh
# ---------------------------------------------------------------------------


def test_rank_mesh_logs_every_call():
    mesh = make_local_mesh(device=CPU)
    x = torch.ones(2, 3, dtype=torch.complex64)
    got = mesh.all_gather(x).wait()
    assert got.shape == (1, 2, 3)
    mesh.barrier()
    assert mesh.all_reduce_max(2.5) == 2.5
    pend = mesh.exchange([], [])
    assert pend.wait() == [] and pend.wait() == []        # logged once
    kinds = [e.kind for e in mesh.log.events]
    assert kinds == ["all_gather", "wait", "barrier", "all_reduce_max",
                     "exchange", "wait"]
    ev = mesh.log.events
    assert (ev[0].shape, ev[0].dtype) == ((2, 3), "complex64")
    assert ev[1].issue == 0 and ev[5].issue == 4 and ev[4].round == 0
    assert ev[0].seq < ev[1].seq < ev[5].seq
    # comparisons leave the sequence number out
    assert dataclasses.replace(ev[0], seq=-5) == ev[0]
    assert mesh.log.since(4) == [MeshEvent("exchange", round=0),
                                 MeshEvent("wait", issue=0)]


def test_dry_mesh_moves_no_data():
    mesh = S.DryMesh(3, 1, CPU)
    x = torch.arange(4.0)
    assert torch.equal(mesh.all_gather(x).wait(), torch.stack([x] * 3))
    got = mesh.exchange([(0, x)], [(2, (2, 5), torch.complex64)]).wait()
    assert got[0].shape == (2, 5) and got[0].dtype == torch.complex64
    assert not got[0].any()
    assert mesh.all_reduce_max(7.0) == 7.0
    mesh.barrier()
    ex = mesh.log.events[2]
    assert ex.sends == ((0, (4,), "float32"),)
    assert ex.recvs == ((2, (2, 5), "complex64"),)
    assert mesh.shape == {"data": 3} and not mesh.staged


# ---------------------------------------------------------------------------
# the fused exchange against the reference's permute pins
# ---------------------------------------------------------------------------

_REF_PERMUTES = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"
    from repro.analysis import check as RC
    from repro.launch.hlo_analysis import analyze_hlo
    for grid in ((2, 2), (4, 1), (1, 4)):
        jfn, xargs = RC._fused_exchange(grid, 4)
        text = jfn.lower(*xargs).compile().as_text()
        n = analyze_hlo(text)["count_per_kind"].get("collective-permute", 0)
        print(f"{grid[0]}x{grid[1]} {n}")
""")


@pytest.fixture(scope="module")
def reference_permutes():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", _REF_PERMUTES], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return {line.split()[0]: int(line.split()[1])
            for line in proc.stdout.splitlines() if "x" in line}


@pytest.mark.parametrize("grid,want", [((2, 2), 4), ((4, 1), 2), ((1, 4), 2)])
def test_exchange_directions_match_the_reference_permutes(grid, want,
                                                          reference_permutes):
    logs = S.simulate(_fused, 4, grid, device=CPU)
    directions = {peer - r for r, events in enumerate(logs)
                  for e in events if e.kind == "exchange" for peer, _, _ in e.sends}
    assert len(directions) == want == reference_permutes[f"{grid[0]}x{grid[1]}"]
    assert S.verify_schedules(logs, label=str(grid)).ok


# ---------------------------------------------------------------------------
# the nine cases of the reference's schedule section
# ---------------------------------------------------------------------------

CASES = CK.schedule_cases(4, 6, CPU)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_schedule_case_verifies_clean(case):
    label, fn, world, args, kw = case
    rep = S.verify_entry(fn, *args, world=world, label=label, device=CPU, **kw)
    assert rep.ok, rep.diff_text()
    assert rep.ranks == world and all(rep.schedules)
    assert "CONSISTENT" in rep.diff_text()
    assert any(e.kind == "all_gather" for e in rep.schedules[0])


@pytest.fixture(scope="module")
def slab_logs():
    label, fn, world, args, kw = CASES[0]
    return S.simulate(fn, world, *args, device=CPU, **kw)


def test_planted_dropped_all_gather_is_flagged(slab_logs):
    logs = [list(events) for events in slab_logs]
    k = next(i for i, e in enumerate(logs[2]) if e.kind == "all_gather")
    del logs[2][k]
    rep = S.verify_schedules(logs, label="dropped")
    assert not rep.ok
    diff = rep.diff_text()
    assert "DIVERGENT" in diff and "rank 2" in diff and "round" in diff
    assert "block in this collective for ever" in diff or "diverges" in diff
    assert "rank 2: " in diff                 # the per-rank listing


def test_planted_misshaped_send_is_flagged(slab_logs):
    logs = [list(events) for events in slab_logs]
    k, e = next((i, e) for i, e in enumerate(logs[1])
                if e.kind == "exchange" and e.sends)
    peer, shape, dtype = e.sends[0]
    logs[1][k] = dataclasses.replace(
        e, sends=((peer, shape[:-1] + (shape[-1] + 1,), dtype),) + e.sends[1:])
    rep = S.verify_schedules(logs, label="misshaped")
    assert not rep.ok
    want = f"round {e.round}: rank 1 sends to rank {peer}"
    assert any(want in p and "receives" in p for p in rep.problems), rep.problems
    assert want in rep.diff_text()


def _exchange(r, sends=(), recvs=()):
    return MeshEvent("exchange", round=r, sends=tuple(sends), recvs=tuple(recvs))


SH = ((2, 2), "float32")


@pytest.mark.parametrize("logs,needle", [
    ([[_exchange(0, [(0, *SH)])], [_exchange(0)]], "send to itself"),
    ([[_exchange(0, [(5, *SH)])], [_exchange(0)]], "out of range"),
    ([[_exchange(0, [(1, *SH), (1, *SH)])], [_exchange(0, recvs=[(0, *SH)])]],
     "twice in one round"),
    ([[_exchange(0)], [_exchange(0, recvs=[(0, *SH)])]],
     "rank 1 waits for a message from rank 0"),
    ([[_exchange(0, [(1, *SH)])], [_exchange(0)]], "posts no receive"),
    ([[_exchange(0, [(1, *SH)])], []], "has no round 0"),
    ([[MeshEvent("wait", issue=3)], []], "wait names no issue"),
    ([[_exchange(0), MeshEvent("wait", issue=0), MeshEvent("wait", issue=0)],
      [_exchange(0)]], "waited twice"),
    ([[MeshEvent("barrier")], []], "first unmatched"),
    ([[MeshEvent("all_gather", shape=(2,), dtype="float32")],
      [MeshEvent("all_gather", shape=(3,), dtype="float32")]], "diverges"),
])
def test_sanity_checks_planted(logs, needle):
    rep = S.verify_schedules(logs)
    assert not rep.ok and any(needle in p for p in rep.problems), rep.problems


def test_same_schedule_names_the_first_difference(slab_logs):
    a = slab_logs[0]
    assert S.same_schedule(a, list(a)) is None
    b = list(a)
    b[1] = dataclasses.replace(b[1], kind="barrier")
    assert S.same_schedule(a, b).startswith("event 1:")
    assert S.same_schedule(a, a[:-1]) == f"{len(a)} events vs {len(a) - 1}"


# ---------------------------------------------------------------------------
# real ranks against the dry simulation
# ---------------------------------------------------------------------------


def _real_rank(mesh, spec):
    """One rank's schedules of the slab and 2x2 evaluations and of an RK2
    step on the slab plan, each cut out of the mesh's log."""
    level, p = spec["level"], spec["p"]
    tree, index = CK.fmm_fixture(level, p, n=1500, device="cpu")
    slab, block = CK.plans(index, level, p, tree.slots, mesh.size, (2, 2))
    out = {}
    for name, fn, args, kw in (
            ("slab", pf.parallel_fmm_evaluate, (tree, p), {"plan": slab}),
            ("block", pf.parallel_fmm_evaluate, (tree, p), {"plan": block}),
            ("rk2", stp.rk2_step, (tree, 1e-4), {"p": p, "plan": slab})):
        mark = len(mesh.log)
        fn(*args, mesh=mesh, **kw)
        out[name] = mesh.log.since(mark)
    out["all"] = list(mesh.log.events)
    return out


def test_real_ranks_log_the_dry_schedules():
    level, p = 4, 6
    ranks = spawn_world(_real_rank, 4, device="cpu", timeout_s=300,
                        args=({"level": level, "p": p},))
    tree, index = CK.fmm_fixture(level, p, n=1500)
    slab, block = CK.plans(index, level, p, tree.slots, 4, (2, 2))
    dry = {"slab": S.simulate(pf.parallel_fmm_evaluate, 4, tree, p, plan=slab,
                              device=CPU),
           "block": S.simulate(pf.parallel_fmm_evaluate, 4, tree, p, plan=block,
                               device=CPU),
           "rk2": S.simulate(stp.rk2_step, 4, tree, 1e-4, p=p, plan=slab,
                             device=CPU)}
    for name, logs in dry.items():
        real = [r[name] for r in ranks]
        for rank, (a, b) in enumerate(zip(real, logs)):
            assert S.same_schedule(a, b) is None, (name, rank, S.same_schedule(a, b))
        assert S.verify_schedules(real, label=name).ok
    rep = S.verify_schedules([r["all"] for r in ranks], label="whole run")
    assert rep.ok, rep.diff_text()
