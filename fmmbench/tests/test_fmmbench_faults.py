"""A run with the timed path broken underneath comes out not correct.

Each test drives a small copy of a cell on the CPU (the harness's look for
a card skipped) with one fault planted in the program, and sees the check
turn ``correct`` false; the sound run beside them is correct.  The faults
a one-card cell can have: a step that returns its state unchanged (for an
evaluation, a stale answer); half of the sources left out, the rest
doubled to keep the mean; an answer altered where it is produced.  No
cell here exchanges data between cards.  The control runs beside the
program on the same captures and must fail.
"""
from __future__ import annotations

import pytest
import torch

from fmmbench.tests import tiny
from repro_torch.core import fmm
from repro_torch.core import stepper as st_mod


@pytest.fixture
def restore():
    saved = {(m, n): getattr(m, n) for m, n in ((fmm, "fmm_evaluate"), (st_mod, "rk2_step"))}
    yield
    for (m, n), v in saved.items():
        setattr(m, n, v)


def half_the_sources(orig):
    def call(tree, p, *args, **kwargs):
        keep = torch.zeros_like(tree.mask)
        keep[..., ::2] = True
        mask = tree.mask & keep
        half = type(tree)(z=tree.z, q=torch.where(mask, 2 * tree.q, 0), mask=mask,
                          level=tree.level, sigma=tree.sigma)
        return orig(half, p, *args, **kwargs)
    return call


def altered(orig):
    def call(tree, p, *args, **kwargs):
        out = orig(tree, p, *args, **kwargs)
        w = out[0] if isinstance(out, tuple) else out
        w = w.clone()
        w[::8] *= 1.001          # one leaf row in eight, a part in a thousand
        return (w, *out[1:]) if isinstance(out, tuple) else w
    return call


def stale(orig):
    first = []

    def call(tree, p, *args, **kwargs):
        out = orig(tree, p, *args, **kwargs)
        if not first:
            first.append(out)
        return first[0]
    return call


def unchanged_step(orig):
    def call(tree, dt, payload=None, **kwargs):
        new, aux, ok, occ, health = orig(tree, dt, payload, **kwargs)
        return tree, payload, ok, occ, health
    return call


@pytest.mark.parametrize("name", tiny.CELLS)
def test_sound_runs_are_correct_and_their_control_is_not(name):
    res = tiny.run_small(name, seed=2 ** 31 + 11, control=True)
    assert res["correct"], res["checks"]
    assert not res["control_correct"], res["control_checks"]


@pytest.mark.parametrize("name", tiny.CELLS)
@pytest.mark.parametrize("fault", ["half_the_sources", "altered", "unchanged"])
def test_a_planted_fault_turns_correct_false(name, fault, restore):
    if fault == "unchanged" and name == "vortex_rk2":
        st_mod.rk2_step = unchanged_step(st_mod.rk2_step)
    elif fault == "unchanged":
        fmm.fmm_evaluate = stale(fmm.fmm_evaluate)
    else:
        fmm.fmm_evaluate = {"half_the_sources": half_the_sources,
                            "altered": altered}[fault](fmm.fmm_evaluate)
    res = tiny.run_small(name, seed=23)
    assert not res["correct"], res["checks"]
