"""The port's stepper on the CUDA card, against itself on the CPU.

Imports no jax, so ``pytest -m gpu`` runs it where jax is absent; the
cases decide inside the test whether a card exists.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.stepper import VortexStepper


def _by_id(stepper, n):
    pos, _ = stepper.particles()
    ids = np.rint(stepper._gather_payload_values()["id"].real).astype(int)
    out = np.full((n, 2), np.nan)
    out[ids] = pos
    return out


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _small(device, faults=None, steps=3):
    rng = np.random.default_rng(1)
    pos = 0.02 + 0.96 * rng.random((2000, 2))
    gamma = rng.standard_normal(2000) * 0.1
    st = VortexStepper(pos, gamma, 0.02, p=8, dt=0.002, faults=faults,
                       payload={"id": np.arange(2000) + 0j}, device=device)
    return st, [st.step() for _ in range(steps)]


@pytest.mark.gpu
def test_stepper_on_the_card_matches_the_cpu(cuda):
    """The kernels' route against the plain one: the same records, z
    within 5e-5, and no plain call on an unfaulted run."""
    from repro_torch.kernels import m2l, ops, p2p
    ops.PLAIN_CALLS = p2p.LAUNCHES = m2l.LAUNCHES = 0
    gst, grecs = _small(cuda)
    assert ops.PLAIN_CALLS == 0
    level = gst.params.level
    assert p2p.LAUNCHES == 2 * 3 and m2l.LAUNCHES == 2 * (level - 1) * 3
    cst, crecs = _small("cpu")
    assert [(r.recovered, r.releveled, r.replanned, r.level, r.health)
            for r in grecs] == [(r.recovered, r.releveled, r.replanned,
                                 r.level, r.health) for r in crecs]
    assert gst.tree.z.device.type == "cuda"
    assert gst.payload["id"].device.type == "cuda"
    np.testing.assert_allclose(_by_id(gst, 2000), _by_id(cst, 2000), rtol=0,
                               atol=5e-5)


@pytest.mark.gpu
def test_transient_drill_on_the_card_is_bit_exact(cuda):
    from repro_torch.core.faults import FaultInjector, FaultSpec
    base, _ = _small(cuda)
    st, recs = _small(cuda, FaultInjector(FaultSpec("teleport", 2, magnitude=0.6)))
    assert recs[1].recovered == "retry_1"
    for a, b in ((st.tree.z, base.tree.z), (st.tree.q, base.tree.q),
                 (st.tree.mask, base.tree.mask),
                 (st.payload["id"], base.payload["id"])):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_reference_rung_never_runs_on_the_card(cuda):
    """A sticky fault with every rung before the reference one off: on the
    card the ladder skips the kernels' plain versions and raises the typed
    error, whose report carries the kernel route's health; on the CPU the
    same stepper runs the reference rung, as the reference does."""
    from repro_torch.core import stepper as st
    from repro_torch.core.faults import FaultInjector, FaultSpec
    from repro_torch.kernels import ops
    off = st.RecoveryPolicy(max_retries=0, halve_dt=False, relevel=False,
                            expand_domain=False)
    rng = np.random.default_rng(1)
    pos = 0.02 + 0.96 * rng.random((300, 2))
    gamma = rng.standard_normal(300) * 0.1
    rungs = {}
    for device in (cuda, "cpu"):
        s = VortexStepper(pos, gamma, 0.02, p=6, dt=0.002, policy=off,
                          faults=FaultInjector(FaultSpec("overflow", 2, sticky=True)),
                          device=device)
        s.step()
        ops.PLAIN_CALLS = 0
        with pytest.raises(st.StepperFaultError) as e:
            s.step()
        rungs[str(device)] = [a["rung"] for a in e.value.report.attempts]
        assert e.value.report.attempts[-1]["health"]["leaf_overflow"] == 1
        if device == "cpu":
            assert ops.PLAIN_CALLS > 0
        else:
            assert ops.PLAIN_CALLS == 0
    assert rungs == {"cuda": ["step"], "cpu": ["step", "reference"]}
    x = torch.zeros(6, 6, 8, dtype=torch.complex64, device=cuda)
    m = torch.ones(6, 6, 8, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="CPU tensors only"):
        ops.p2p_apply_slab(x, x, m, 0.01, plain=True)
