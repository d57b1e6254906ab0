"""The port's CheckpointManager and the stepper's checkpoints, against the
reference's.

Mirrors the serial cases of ``tests/test_checkpoint.py`` (round trip of
complex and bool trees, crash mid-save, async error surfacing, dangling
LATEST, fsync of the commit point, keep-last-k, the stepper's checkpoint
cycle), and moves checkpoints between the two packages in both directions:
the file format is the reference's, so either restores what the other
wrote, bit for bit.
"""
import dataclasses
import os
import shutil
import threading

import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JManager
from repro.core.stepper import VortexStepper as JStepper
from repro_torch.checkpoint import manager as M
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.stepper import VortexStepper
from repro_torch.core.vortex import lamb_oseen_particles


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the CPU route runs hundreds of small ops a
    step, and under the suite's parallel workers their threads would
    oversubscribe the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fmm_trees(seed=0, n=8, s=4):
    rng = np.random.default_rng(seed)
    z = (rng.random((n, n, s)) + 1j * rng.random((n, n, s))).astype(
        np.complex64)
    q = (rng.standard_normal((n, n, s))
         + 1j * rng.standard_normal((n, n, s))).astype(np.complex64)
    mask = rng.random((n, n, s)) < 0.5
    return {"tree": {"z": torch.as_tensor(z), "q": torch.as_tensor(q),
                     "mask": torch.as_tensor(mask)},
            "payload": {"r0": z * 2.0, "ids": (np.arange(3), [np.ones(2)])}}


def _map(fn, t):
    if isinstance(t, dict):
        return {k: _map(fn, v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return type(t)(_map(fn, v) for v in t)
    return fn(t)


def _templates(trees):
    return _map(lambda t: np.zeros(tuple(t.shape), M.numpy_dtype(t)), trees)


def _assert_trees_equal(out, trees):
    for a, b in zip(M._leaves(out), M._leaves(trees)):
        assert a[0] == b[0]
        want = M.to_host(b[1])
        assert a[1].dtype == want.dtype
        np.testing.assert_array_equal(a[1], want)


def test_pytree_roundtrip(tmp_path):
    trees = _fmm_trees()
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(5, trees, {"level": 3})
    out, meta = mgr.restore(_templates(trees), step=5)
    assert meta["step"] == 5 and meta["level"] == 3
    _assert_trees_equal(out, trees)
    assert out["tree"]["z"].dtype == np.complex64
    assert out["tree"]["mask"].dtype == bool
    assert isinstance(out["payload"]["ids"], tuple)
    assert mgr.load_meta(5)["level"] == 3
    assert mgr.load_meta()["step"] == 5


def test_npz_keys_are_the_references(tmp_path):
    """The keys of each npz, as ``jax.tree_util`` paths spell them (dict
    keys sorted, sequence positions as indices), and the reference's
    manager restores the port's file."""
    trees = _fmm_trees()
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, trees, {"tag": "port"})
    jref = JManager(str(tmp_path / "ref"), async_save=False)
    jref.save(1, _map(M.to_host, trees), {"tag": "port"})
    for name in trees:
        with np.load(tmp_path / "step_1" / f"{name}.npz") as a, \
                np.load(tmp_path / "ref" / "step_1" / f"{name}.npz") as b:
            assert a.files == b.files
            for k in a.files:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
    out, meta = JManager(str(tmp_path), async_save=False).restore(
        _templates(trees), step=1)
    assert meta == {"tag": "port", "step": 1}
    _assert_trees_equal(out, trees)


def test_crash_mid_save_leaves_latest_intact(tmp_path, monkeypatch):
    trees = _fmm_trees()
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, trees, {"tag": "good"})

    def crash(src, dst):
        raise RuntimeError("simulated crash before atomic rename")

    # a crash mid-save of step 2: npz files written, but the process dies
    # before the tmp-dir rename / LATEST update
    monkeypatch.setattr(os, "rename", crash)
    with pytest.raises(RuntimeError, match="simulated crash"):
        mgr.save(2, _fmm_trees(seed=9), {"tag": "bad"})
    monkeypatch.undo()

    assert mgr.latest_step() == 1
    assert mgr.all_steps() == [1]
    out, meta = mgr.restore(_templates(trees))
    assert meta["tag"] == "good"
    np.testing.assert_array_equal(out["tree"]["z"], trees["tree"]["z"].numpy())
    # a later successful save cleans up and moves LATEST forward
    mgr.save(3, trees, {"tag": "next"})
    assert mgr.latest_step() == 3


def test_async_save_error_surfaces(tmp_path, monkeypatch):
    """An exception in the async writer thread re-raises on the next
    save()/wait(), never dies silently."""
    trees = _fmm_trees()
    mgr = CheckpointManager(str(tmp_path), async_save=True)

    def boom(*a, **k):
        raise OSError("disk full (simulated)")

    monkeypatch.setattr(np, "savez", boom)
    mgr.save(1, trees, None)           # returns; the failure is in-thread
    with pytest.raises(RuntimeError, match="async checkpoint save failed"):
        mgr.wait()
    monkeypatch.undo()

    # the error also surfaces on the NEXT save (not just wait)
    monkeypatch.setattr(np, "savez", boom)
    mgr.save(2, trees, None)
    mgr._thread.join(timeout=60)      # let the failing write land while patched
    assert not mgr._thread.is_alive()
    monkeypatch.undo()
    with pytest.raises(RuntimeError, match="async checkpoint save failed"):
        mgr.save(3, trees, None)
    # once surfaced it is cleared: the pipeline keeps going
    mgr.save(4, trees, None)
    mgr.wait()
    assert mgr.latest_step() == 4


def test_async_save_writes_the_values_at_save_time(tmp_path, monkeypatch):
    """The writer thread writes what the tensors held when save() returned,
    though training updates them in place before it runs: CPU tensors of
    every dtype, held back until the update has happened."""
    tree = {"f32": torch.zeros(4), "bf16": torch.zeros(4, dtype=torch.bfloat16),
            "i32": torch.zeros(4, dtype=torch.int32), "np": np.zeros(4)}
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    updated, savez = threading.Event(), np.savez

    def late_savez(*a, **k):
        assert updated.wait(60)
        savez(*a, **k)

    monkeypatch.setattr(np, "savez", late_savez)
    mgr.save(1, {"params": tree})
    for leaf in tree.values():
        leaf += 1                         # the next step's in-place update
    updated.set()
    mgr.wait()
    out, _ = mgr.restore({"params": tree})
    assert all(not a.any() for a in out["params"].values())


def test_latest_step_falls_back_when_latest_dangles(tmp_path):
    trees = _fmm_trees()
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, trees, {"tag": "one"})
    mgr.save(2, trees, {"tag": "two"})
    shutil.rmtree(tmp_path / "step_2")
    assert mgr.latest_step() == 1
    out, meta = mgr.restore(_templates(trees))
    assert meta["tag"] == "one"
    (tmp_path / "LATEST").write_text("not-a-step")
    assert mgr.latest_step() == 1
    shutil.rmtree(tmp_path / "step_1")
    assert mgr.latest_step() is None
    assert mgr.restore(_templates(trees)) == (None, None)


def test_commit_point_fsyncs(tmp_path, monkeypatch):
    synced = []
    real_fsync = os.fsync
    monkeypatch.setattr(os, "fsync", lambda fd: synced.append(fd)
                        or real_fsync(fd))
    trees = _fmm_trees()
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, trees, None)
    # 2 payload npz + meta.json + LATEST.tmp + >= 2 directory fsyncs
    assert len(synced) >= 6


def test_keep_last_k_gc(tmp_path):
    trees = _fmm_trees()
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=False)
    for s in range(1, 7):
        mgr.save(s, trees, None)
    assert mgr.all_steps() == [4, 5, 6]
    assert mgr.latest_step() == 6
    out, meta = mgr.restore(_templates(trees), step=4)
    assert meta["step"] == 4


def test_restore_rejects_a_shape_mismatch(tmp_path):
    trees = _fmm_trees()
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, trees, None)
    bad = _templates(trees)
    bad["tree"]["z"] = np.zeros((4, 4, 4), np.complex64)
    with pytest.raises(ValueError, match="shape mismatch at z"):
        mgr.restore(bad)


def _lattice_stepper(cls, directory, **extra):
    pos, gamma, sigma = lamb_oseen_particles(24)
    r0 = np.hypot(pos[:, 0] - 0.5, pos[:, 1] - 0.5)
    return cls(pos, gamma, sigma, p=6, dt=0.002, payload={"r0": r0 + 0j},
               checkpoint_dir=str(directory), checkpoint_every=2, **extra)


def test_stepper_checkpoint_cycle(tmp_path):
    """Periodic snapshots land, rollback is bit-exact on tree AND payload,
    and from_checkpoint resumes the identical state."""
    st = _lattice_stepper(VortexStepper, tmp_path, device="cpu")
    for _ in range(4):
        st.step()
    st._ckpt.wait()
    assert st._ckpt.all_steps() == [2, 4]
    state4 = [t.clone() for t in (st.tree.z, st.tree.q, st.tree.mask,
                                  st.payload["r0"])]
    st.step()
    assert st.rollback() == 4
    assert st.step_count == 4
    for a, b in zip((st.tree.z, st.tree.q, st.tree.mask, st.payload["r0"]),
                    state4):
        assert a.dtype == b.dtype and torch.equal(a, b)

    st2 = VortexStepper.from_checkpoint(str(tmp_path), device="cpu")
    assert st2.step_count == 4
    assert st2.sigma == st.sigma and st2.dt == st.dt and st2.p == st.p
    assert st2.params == st.params and st2.plan == st.plan
    assert torch.equal(st2.tree.z, state4[0])
    assert torch.equal(st2.payload["r0"], state4[3])
    st2.step()     # the restored stepper keeps stepping


def _same_setup(a, b):
    """Level, slots, cut, plan, domain and scales agree (the two packages'
    dataclasses are distinct types, so compared by value)."""
    return (dataclasses.asdict(a.params) == dataclasses.asdict(b.params)
            and a.plan.describe() == b.plan.describe()
            and (a.domain.origin, a.domain.size) == (b.domain.origin, b.domain.size)
            and (a.sigma, a.dt, a.p) == (b.sigma, b.dt, b.p))


def _state(st):
    return [np.asarray(a) for a in (st.tree.z, st.tree.q, st.tree.mask,
                                    st.payload["r0"])]


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    """A checkpoint the port's stepper writes is restored by the
    reference's ``VortexStepper.from_checkpoint`` bit for bit (keys,
    dtypes, shapes and meta fields as the reference writes them)."""
    st = _lattice_stepper(VortexStepper, tmp_path, device="cpu")
    st.step()
    st.step()
    st._ckpt.wait()
    js = JStepper.from_checkpoint(str(tmp_path))
    assert js.step_count == 2 and _same_setup(js, st)
    for a, b in zip(_state(js), _state(st)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert float(js.tree.sigma) == float(st.tree.sigma)
    js.step()


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    """And the reverse: the reference's stepper writes, the port's
    ``from_checkpoint`` restores bit for bit and steps on."""
    js = _lattice_stepper(JStepper, tmp_path)
    js.step()
    js.step()
    js._ckpt.wait()
    st = VortexStepper.from_checkpoint(str(tmp_path), device="cpu")
    assert st.step_count == 2 and _same_setup(st, js)
    for a, b in zip(_state(st), _state(js)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    st.step()
    # the port's next snapshot reads back in the reference too
    st.save_checkpoint()
    st._ckpt.wait()
    js2 = JStepper.from_checkpoint(str(tmp_path))
    assert js2.step_count == 3
    np.testing.assert_array_equal(np.asarray(js2.tree.z), st.tree.z.numpy())
