"""The port's kill-drill supervisor (``repro_torch.launch.supervisor``) on
CPU rank processes, at the reference drills' scenario (n_side 20, p 4,
dt 0.004, a checkpoint every 2 steps; ``tests/test_resilience.py``).

The SIGKILL drill: rank 2 of 4 is killed mid-step 4, the run completes at
step 6 on ranks (0, 1, 3), every survivor holds the same tree, bit for bit
a clean 3-rank ``spawn_world`` restored from the same checkpoint, and
within 1e-5 of the reference's clean 3-device run from that checkpoint
(one jax subprocess on forced host devices; the checkpoint format is
shared).  The SIGSTOP drill: rank 1 of 3 stops at step 3, the stale
heartbeat is detected in under 120 s, and the run completes at step 5 on
(0, 2).  Every subprocess has a timeout and the supervisor a ``max_wall``,
so a hang fails the test instead of holding the suite.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.core.faults import FaultInjector, FaultSpec
from repro_torch.launch import supervisor as sv
from repro_torch.launch.mesh import spawn_world
from repro_torch.parallel import resilience as rz

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
N_SIDE, P, DT = 20, 4, 0.004
MAX_WALL = 240.0


def _config(tmp_path, world, target, min_world):
    return sv.SupervisorConfig(
        world=world, target_step=target, coord_dir=str(tmp_path),
        n_side=N_SIDE, p=P, dt=DT, checkpoint_every=2, checkpoint_keep=8,
        device="cpu",
        watchdog=rz.WatchdogPolicy(compile_grace=120.0, teardown_grace=30.0,
                                   agree_timeout=60.0),
        restart=rz.RestartPolicy(min_world=min_world, backoff_base=0.1),
        max_wall=MAX_WALL)


def _worker_logs(coord_dir):
    out = []
    for root, _, names in os.walk(coord_dir):
        for n in sorted(names):
            if n.endswith(".log"):
                with open(os.path.join(root, n), errors="replace") as f:
                    out.append(f"--- {os.path.join(root, n)}\n" + f.read())
    return "\n".join(out)


def _run(cfg, *specs):
    try:
        return sv.Supervisor(cfg, faults=FaultInjector(*specs)).run()
    except rz.MeshFaultError as e:
        pytest.fail(f"drill did not survive: {e}\n{_worker_logs(cfg.coord_dir)}")


def _load(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _reference_clean_run(ckpt_dir, world, restore_step, target, out_path):
    """The reference's clean run: one process, ``world`` forced host
    devices, ``from_checkpoint`` at the drill's restore step, its jnp
    route, stepped to the target."""
    body = textwrap.dedent(f"""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count={world}"
        import numpy as np
        from repro.core.stepper import VortexStepper
        from repro.launch.mesh import make_world_mesh

        st = VortexStepper.from_checkpoint(
            {ckpt_dir!r}, mesh=make_world_mesh({world}), step={restore_step},
            plan_method="model", use_kernels=False, checkpoint_every=0)
        while st.step_count < {target}:
            st.step()
        np.savez({out_path!r}, z=np.asarray(st.tree.z),
                 q=np.asarray(st.tree.q), mask=np.asarray(st.tree.mask))
    """)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", body], capture_output=True,
                       text=True, timeout=300, env=env)
    assert r.returncode == 0, f"\nSTDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"


@pytest.fixture(scope="module")
def kill_drill(tmp_path_factory):
    """4 ranks, rank 2 SIGKILLed mid-step 4, run to step 6; the survivors'
    trees, a clean 3-rank restore's and the reference's."""
    tmp = tmp_path_factory.mktemp("kill_drill")
    cfg = _config(tmp / "coord", world=4, target=6, min_world=2)
    result = _run(cfg, FaultSpec(site="proc_kill", step=4, device=2))
    outs = {r: _load(os.path.join(result.result_dir, f"result_{r}.npz"))
            for r in result.ranks}
    records = {}
    for r in result.ranks:
        with open(os.path.join(result.result_dir, f"result_{r}.json")) as f:
            records[r] = json.load(f)
    rep = result.faults[0]
    clean = spawn_world(sv.clean_restore, 3, device="cpu", timeout_s=120,
                        args=(cfg.checkpoint_dir, rep.restore_step, 6,
                              sv.restore_kwargs(cfg)))
    ref_path = str(tmp / "reference3.npz")
    _reference_clean_run(cfg.checkpoint_dir, 3, rep.restore_step, 6, ref_path)
    return {"cfg": cfg, "result": result, "outs": outs, "records": records,
            "clean": clean, "reference": _load(ref_path)}


def test_kill_drill_survivors_schedules_agree(kill_drill):
    """The survivors' mesh logs (restore and steps to 6 on the 3-rank
    group) pass the collective-schedule verifier: the same collectives on
    every rank, every send met by its receive."""
    from repro_torch.analysis.schedule import verify_schedules
    from repro_torch.launch.mesh import MeshEvent
    recs = sorted(kill_drill["records"].values(), key=lambda r: r["mesh_rank"])
    assert [r["mesh_rank"] for r in recs] == [0, 1, 2]
    logs = [[MeshEvent.from_json(e) for e in r["mesh_log"]] for r in recs]
    assert all(any(e.kind == "all_gather" for e in log) for log in logs)
    rep = verify_schedules(logs, label="kill drill survivors")
    assert rep.ok, rep.diff_text()


def test_kill_drill_completes_on_3_survivors(kill_drill):
    result = kill_drill["result"]
    assert result.success and result.final_step == 6
    assert len(result.faults) == 1
    rep = result.faults[0]
    assert 2 in rep.dead and rep.hung == ()
    assert (rep.world_before, rep.world_after) == (4, 3)
    assert rep.restore_step in (0, 2, 4)
    assert result.ranks == (0, 1, 3)
    assert [g["ranks"] for g in result.generations] == [[0, 1, 2, 3], [0, 1, 3]]
    assert rep.detect_seconds is not None and rep.detect_seconds < 120.0
    assert rep.restore_seconds is not None and rep.restore_seconds > 0.0
    for g in result.generations:
        assert 0 < g["spawn_to_restored_s"] <= g["spawn_to_first_step_s"]
    # each survivor stepped from the restore point to 6 on the CPU: no
    # kernel launch, no plain call counted (the CPU dispatch), no recovery
    for r, rec in kill_drill["records"].items():
        assert rec["ranks"] == [0, 1, 3] and rec["device"] == "cpu"
        assert [s["step"] for s in rec["steps"]] == \
            list(range(rep.restore_step + 1, 7))
        assert all(s["recovered"] == "" and s["p2p"] == s["m2l"] == s["plain"] == 0
                   for s in rec["steps"])


def test_kill_drill_survivors_agree_bit_for_bit(kill_drill):
    outs = list(kill_drill["outs"].values())
    assert all(int(o["step"]) == 6 for o in outs)
    for o in outs[1:]:
        for k in ("z", "q", "mask"):
            np.testing.assert_array_equal(o[k], outs[0][k])


def test_kill_drill_equals_a_clean_3_rank_restore(kill_drill):
    """Bit for bit each rank of a clean 3-rank world restored from the
    checkpoint the survivors restored from."""
    got = kill_drill["outs"][0]
    assert len(kill_drill["clean"]) == 3
    for clean in kill_drill["clean"]:
        for k in ("z", "q", "mask"):
            np.testing.assert_array_equal(got[k], clean[k],
                                          err_msg=f"{k} diverged from the clean run")


def test_kill_drill_within_1e_5_of_the_reference(kill_drill):
    """The reference's clean 3-device run from the same checkpoint: the
    same occupancy, positions within 1e-5 (f32 sums in another order)."""
    got, ref = kill_drill["outs"][0], kill_drill["reference"]
    np.testing.assert_array_equal(got["mask"], ref["mask"])
    m = got["mask"]
    err = np.linalg.norm(got["z"][m] - ref["z"][m]) / np.linalg.norm(ref["z"][m])
    assert err < 1e-5, err
    np.testing.assert_array_equal(got["q"], ref["q"])


def test_hang_drill_sigstop_detected_within_deadline(tmp_path):
    """Hung, not dead: rank 1 of 3 SIGSTOPped at step 3.  The stale
    heartbeat is detected in bounded time (under 120 s), the survivors
    shrink to (0, 2), and the run completes at step 5."""
    cfg = _config(tmp_path, world=3, target=5, min_world=1)
    result = _run(cfg, FaultSpec(site="proc_hang", step=3, device=1))
    assert result.success and result.final_step == 5
    assert len(result.faults) == 1
    rep = result.faults[0]
    assert 1 in (rep.hung + rep.dead)
    assert rep.world_after == 2
    assert result.ranks == (0, 2)
    assert rep.detect_seconds is not None and rep.detect_seconds < 120.0
    outs = [_load(os.path.join(result.result_dir, f"result_{r}.npz"))
            for r in result.ranks]
    for k in ("z", "q", "mask"):
        np.testing.assert_array_equal(outs[0][k], outs[1][k])


def test_cli_without_device_needs_the_card(monkeypatch, tmp_path):
    """Without ``--device`` the ranks run on the CUDA card; with none the
    command raises before it starts a process."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sv.main(["--world", "2", "--target-step", "1",
                 "--coord-dir", str(tmp_path)])
    assert not os.path.exists(os.path.join(tmp_path, "gen_0"))


def test_group_timeout_is_the_first_step_deadline():
    """A rank's collectives wait as long as a step with no estimate may
    take (the compile grace), never for ever."""
    pol = rz.WatchdogPolicy(compile_grace=120.0, margin=3.0, slack=2.0)
    assert sv.group_timeout(pol) == rz.step_deadline(pol, None) == 120.0
    assert sv.group_timeout(pol) == rz.step_deadline(pol, 0.5, compiled=False)
