"""The benchmark on the card, at the small cells' size.

Run on a machine with a CUDA card, from the root of a checkout:

    python -m pytest -q -m gpu fmmbench/tests

Each test decides inside itself whether there is a card and skips
without one.  At the cells' own size the same readings come from
``python3 -m fmmbench.control`` (PERF.md).
"""
from __future__ import annotations

import dataclasses

import pytest
import torch

from fmmbench import run
from fmmbench.tests import tiny

pytestmark = pytest.mark.gpu

SEEDS = (3, 2 ** 31 + 7, 40_000_000_001)


def card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("name", tiny.CELLS)
def test_program_is_correct_and_its_control_is_not_on_three_seeds(name):
    dev = card()
    for seed in SEEDS:
        res = run.run_cell(tiny.cell(name), seed, 1.0, False, dev, control=True)
        assert run.passed(res["checks"]) and res["window"]["failed"] == 0, res["checks"]
        assert not run.passed(res["control_checks"]), res["control_checks"]


@pytest.mark.parametrize("name", tiny.CELLS)
def test_a_traced_run_reads_every_per_layer_metric_of_its_cell(name):
    dev = card()
    cell = tiny.cell(name)
    traffic = dict(cell.traffic, trace={"start": 2, "steps": 4})
    cell = dataclasses.replace(cell, traffic=traffic)
    res = run.run_cell(cell, 9, 3.0, True, dev)
    got = run.per_layer(cell, res["trace"], res["window"])
    want = {m["name"] for m in cell.per_layer}
    assert set(got) == want, (set(got), want)
    for m in got:
        if got[m]["unit"] == "%":
            assert 0 < got[m]["value"] <= 105, (m, got[m])
    assert res["trace"]["profile"]["busy_s"] > 0
