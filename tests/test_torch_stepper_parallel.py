"""The port's ``VortexStepper`` on a mesh of 4 CPU ranks against the
reference's stepper on 4 forced host devices.

The reference runs once, in a subprocess, and the port once, in a
``spawn_world`` of 4 gloo ranks; each case below reads both.  Inputs are
those of the reference's fault drills (``tests/test_faults.py``): 300
particles (numpy seed 1), sigma 0.02, p = 6, dt = 0.002, each carrying its
index as a payload so positions compare particle by particle.

Scenarios: a dynamic slab stepper re-planning every step; the grid-bound
``halo_nan`` drill that the plan-fallback rung escapes on ``plan_slab``;
the sticky ``halo_nan`` drill that only the serial ``reference`` rung
escapes (the CPU); a restore of a 4-rank checkpoint onto 2 ranks and onto
1; and one rank whose clock runs slow.  Every rank must record the same
steps, plans and positions bit for bit.
"""
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.faults import FaultInjector, FaultSpec
from repro_torch.core.stepper import RecoveryPolicy, VortexStepper
from repro_torch.launch.mesh import make_group_mesh, spawn_world

ROOT = Path(__file__).resolve().parents[1]
STEPS = 3
SLOW_S = 0.05          # the slow rank's extra seconds a step
SCENARIOS = {
    "dynamic": ("None", "dict(dynamic=True, replan_every=1)"),
    "plan_slab": ('FaultInjector(FaultSpec("halo_nan", step=2, sticky=True, '
                  'only_grid=(2, 2)))',
                  "dict(plan_grid=(2, 2), target_per_box=3.0, "
                  "policy=RecoveryPolicy(expand_domain=False))"),
    "reference": ('FaultInjector(FaultSpec("halo_nan", step=2, sticky=True))',
                  "dict(policy=RecoveryPolicy(expand_domain=False))"),
}
RECORD_FIELDS = ("step", "load_balance", "replanned", "releveled", "level",
                 "recovered", "health")

_INPUTS = textwrap.dedent("""
    rng = np.random.default_rng(1)
    pos = 0.02 + 0.96 * rng.random((300, 2))
    gamma = rng.standard_normal(300) * 0.1
    ids = np.arange(300, dtype=np.int32)
    KW = dict(sigma=0.02, p=6, dt=0.002)
""")

_REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np
    import jax
    from jax.sharding import Mesh
    from repro.core.faults import FaultInjector, FaultSpec
    from repro.core.stepper import RecoveryPolicy, VortexStepper
""") + _INPUTS + textwrap.dedent("""
    mesh = Mesh(np.array(jax.devices()), ("data",))
    out = {}
    for name, (faults, extra) in SCENARIOS.items():
        st = VortexStepper(pos, gamma, mesh=mesh, payload={"id": ids},
                           faults=eval(faults), **KW, **eval(extra))
        recs = [st.step() for _ in range(STEPS)]
        m = np.asarray(st.tree.mask)
        order = np.argsort(np.asarray(st.payload["id"])[m])
        out[name + "_z"] = np.asarray(st.tree.z)[m][order]
        out[name + "_records"] = np.array(
            [[0.0 if f == "recovered" else float(getattr(r, f)) for f in FIELDS]
             for r in recs])
        out[name + "_rungs"] = np.array([r.recovered for r in recs])
        out[name + "_plan"] = np.array(st.plan.describe())
    np.savez(sys.argv[1], **out)
    print("OK")
""")


def _scenario_args():
    return f"SCENARIOS = {SCENARIOS!r}\nSTEPS = {STEPS}\nFIELDS = {RECORD_FIELDS!r}\n"


def _state(st):
    m = st.tree.mask
    order = torch.argsort(st.payload["id"][m])
    return st.tree.z[m][order].numpy()


def _records(recs):
    return [{f: getattr(r, f) for f in RECORD_FIELDS + ("seconds",)}
            for r in recs]


def _rank_world(mesh, ck_dir):
    """Every scenario of the port on this rank."""
    ns: dict = {}
    exec(_INPUTS, {"np": np}, ns)
    pos, gamma, ids, kw = ns["pos"], ns["gamma"], ns["ids"], ns["KW"]
    env = {"FaultInjector": FaultInjector, "FaultSpec": FaultSpec,
           "RecoveryPolicy": RecoveryPolicy}
    out = {}
    for name, (faults, extra) in SCENARIOS.items():
        st = VortexStepper(pos, gamma, mesh=mesh, payload={"id": ids},
                           faults=eval(faults, env), **kw, **eval(extra, env))
        recs = [st.step() for _ in range(STEPS)]
        out[name] = {"records": _records(recs), "z": _state(st),
                     "plan": st.plan.describe()}
    # a 4-rank checkpoint at step 2, restored onto 2 ranks and onto 1
    st = VortexStepper(pos, gamma, mesh=mesh, payload={"id": ids},
                       checkpoint_dir=ck_dir, checkpoint_every=2, **kw)
    for _ in range(2):
        st.step()
    st.wait_checkpoint()
    saved = [t.clone() for t in (st.tree.z, st.tree.q, st.tree.mask,
                                 st.payload["id"])]
    st.step()
    out["restore"] = {"z4": _state(st), "level": st.params.level}
    two = make_group_mesh(range(2), device="cpu")
    targets = [("two", two)] + ([("one", None)] if mesh.rank == 0 else [])
    for name, m in targets:
        if name == "two" and m is None:
            continue
        back = VortexStepper.from_checkpoint(ck_dir, mesh=m, device="cpu")
        now = (back.tree.z, back.tree.q, back.tree.mask, back.payload["id"])
        same = all(a.dtype == b.dtype and torch.equal(a, b)
                   for a, b in zip(now, saved))
        nparts = back.nparts
        back.step()
        out["restore"][name] = {"bit_for_bit": same, "step": back.step_count,
                                "nparts": nparts, "z": _state(back)}
    mesh.barrier()
    # one rank's clock runs slow: every rank records the slowest time
    st = VortexStepper(pos, gamma, mesh=mesh, dynamic=True, replan_every=1,
                       payload={"id": ids}, **kw)
    if mesh.rank == 1:
        run = st._run_rk2

        def slow(*a, **k):
            time.sleep(SLOW_S)
            return run(*a, **k)
        st._run_rk2 = slow
    recs = [st.step() for _ in range(STEPS)]
    out["slow"] = {"records": _records(recs), "z": _state(st),
                   "plan": st.plan.describe()}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("stepper_parallel")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    ref = subprocess.Popen(
        [sys.executable, "-c", _scenario_args() + _REFERENCE, str(d / "ref.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        port = spawn_world(_rank_world, 4, device="cpu", timeout_s=300,
                           args=(str(d / "ck"),))
        stdout, stderr = ref.communicate(timeout=600)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, stdout + stderr
    with np.load(d / "ref.npz") as z:
        reference = {k: z[k] for k in z.files}
    return {"ref": reference, "port": port}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_records_and_rungs_match_reference(runs, name):
    ref, port = runs["ref"], runs["port"][0][name]
    assert [r["recovered"] for r in port["records"]] == list(ref[name + "_rungs"])
    for got, want in zip(port["records"], ref[name + "_records"]):
        for f, w in zip(RECORD_FIELDS, want):
            if f == "recovered":
                continue
            if f == "load_balance":
                assert got[f] == pytest.approx(w, rel=1e-6), f
            else:
                assert float(got[f]) == w, (f, got[f], w)
    assert port["plan"] == str(ref[name + "_plan"])


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_positions_match_reference(runs, name):
    got, want = runs["port"][0][name]["z"], runs["ref"][name + "_z"]
    assert got.shape == want.shape == (300,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_drills_recover_on_the_reference_rungs(runs):
    port = runs["port"][0]
    assert [r["recovered"] for r in port["plan_slab"]["records"]] == \
        ["", "plan_slab", ""]
    assert port["plan_slab"]["records"][1]["replanned"]
    assert "x cols" not in port["plan_slab"]["plan"]       # a slab now
    assert [r["recovered"] for r in port["reference"]["records"]] == \
        ["", "reference", ""]


@pytest.mark.parametrize("name", list(SCENARIOS) + ["slow"])
def test_every_rank_agrees_bit_for_bit(runs, name):
    first = runs["port"][0][name]
    for other in runs["port"][1:]:
        assert other[name]["records"] == first["records"]
        assert other[name]["plan"] == first["plan"]
        np.testing.assert_array_equal(other[name]["z"], first["z"])


@pytest.mark.parametrize("target,nparts", [("two", 2), ("one", 1)])
def test_restore_onto_fewer_ranks_is_bit_for_bit(runs, target, nparts):
    holders = [r["restore"][target] for r in runs["port"]
               if target in r["restore"]]
    assert len(holders) == nparts
    four = runs["port"][0]["restore"]
    for h in holders:
        assert h["bit_for_bit"] and h["nparts"] == nparts and h["step"] == 3
        # the next step on the smaller world agrees with the 4-rank one
        np.testing.assert_allclose(h["z"], four["z4"], rtol=0, atol=1e-5)


def test_a_slow_rank_sets_every_rank_s_step_time(runs):
    recs = [r["slow"]["records"] for r in runs["port"]]
    seconds = [[rec["seconds"] for rec in rs] for rs in recs]
    assert all(s == seconds[0] for s in seconds)
    assert min(seconds[0]) >= SLOW_S
