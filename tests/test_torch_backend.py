"""The port's backend knobs (``repro_torch.configs.backend``), the
counterparts of ``src/repro/configs/backend.py``: ``resolve_device`` gives
the card unless the caller names the CPU, ``set_cpu_cores`` sets the
intra-op threads.  Each test puts the process's setting back."""
import os

import numpy as np
import pytest
import torch

from repro_torch.configs import backend


def test_resolve_device_gives_the_card_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for asked in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            backend.resolve_device(asked)
    assert backend.resolve_device("cpu") == torch.device("cpu")
    assert backend.resolve_device(torch.device("cpu")) == torch.device("cpu")


def test_entry_points_without_a_device_raise_with_no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from repro_torch.core.quadtree import build_tree
    rng = np.random.default_rng(0)
    xy, g = rng.uniform(size=(40, 2)), rng.normal(size=40)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_tree(xy, g, level=2, sigma=0.01)
    tree, _ = build_tree(xy, g, level=2, sigma=0.01, device="cpu")
    assert tree.z.device.type == "cpu"


def test_set_cpu_cores_sets_the_intra_op_threads():
    before = torch.get_num_threads()
    try:
        assert backend.set_cpu_cores(1) == 1 and torch.get_num_threads() == 1
        n = min(2, os.cpu_count() or 1)
        assert backend.set_cpu_cores(n) == n and torch.get_num_threads() == n
        total = os.cpu_count() or 1
        with pytest.warns(Warning, match=f"only {total} CPUs"):
            got = backend.set_cpu_cores(total + 4)
        assert got == max(total - 1, 1) == torch.get_num_threads()
    finally:
        torch.set_num_threads(before)
