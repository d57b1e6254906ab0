"""The yardstick's counts on hand-worked shapes, and the metric readers."""
from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fmmbench import counts, manifest


def random_tree(n: int, s: int, fill: float, seed: int):
    g = torch.Generator().manual_seed(seed)
    z = torch.complex(torch.rand(n, n, s, generator=g), torch.rand(n, n, s, generator=g))
    mask = torch.rand(n, n, s, generator=g) < fill
    return z, mask


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("passive", [False, True])
def test_live_pairs_from_counts_equals_a_brute_force_count(seed, passive):
    n, s = 6, 5
    z, mask = random_tree(n, s, 0.6, seed)
    pad = (0, 0, 1, 1, 1, 1)
    zh, mh = F.pad(z, pad), F.pad(mask, pad)
    brute = 0
    live = [(i, j, k) for i in range(n) for j in range(n) for k in range(s) if mask[i, j, k]]
    tz, tm = random_tree(n, 3, 0.7, seed + 10) if passive else (z, mask)
    targets = [(i, j, k) for i in range(n) for j in range(n) for k in range(tz.shape[-1])
               if tm[i, j, k]]
    for (i, j, k) in targets:
        for (a, b, c) in live:
            if abs(i - a) <= 1 and abs(j - b) <= 1 and tz[i, j, k] != z[a, b, c]:
                brute += 1
    got = counts.live_pairs_from_counts(mask.sum(-1).numpy(),
                                        tm.sum(-1).numpy() if passive else None)
    frozen = counts.live_pairs(zh, mh, tz if passive else None, tm if passive else None)
    assert got == brute == frozen


def brute_interaction_pairs(src, tgt) -> int:
    """Every (target box, source box) pair by its definition, box by box."""
    n = src.shape[0]
    total = 0
    for i in range(n):
        for j in range(n):
            if not tgt[i, j]:
                continue
            for a in range(n):
                for b in range(n):
                    parents_near = abs(a // 2 - i // 2) <= 1 and abs(b // 2 - j // 2) <= 1
                    adjacent = abs(a - i) <= 1 and abs(b - j) <= 1
                    total += bool(src[a, b]) and parents_near and not adjacent
    return total


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n", [4, 8, 16])
def test_interaction_pairs_equal_a_box_by_box_count(seed, n):
    g = np.random.default_rng(seed)
    src = g.integers(0, 3, (n, n)) * (g.random((n, n)) < 0.5)
    tgt = g.integers(0, 3, (n, n)) * (g.random((n, n)) < 0.5)
    assert counts.interaction_pairs(src, tgt) == brute_interaction_pairs(src, tgt)
    assert counts.interaction_pairs(src, src) == brute_interaction_pairs(src, src)


def test_interaction_pairs_on_hand_worked_grids():
    # a full grid: per dimension a box's parent's neighbours' children number
    # 6 (4 at the edge parents), its neighbours 3 (2 at the edges), so the
    # pairs are (6n - 8)^2 - (3n - 2)^2: at level 2 every box with every
    # box less the neighbours, 256 - 100
    for n in (4, 8, 1024):
        full = np.ones((n, n), np.int64)
        assert counts.interaction_pairs(full, full) == (6 * n - 8) ** 2 - (3 * n - 2) ** 2
    assert counts.interaction_pairs(np.ones((4, 4)), np.ones((4, 4))) == 156
    # points in two opposite corner boxes: 2 pairs at level 2, none at level
    # 3, where their parents are not neighbours; empty boxes add nothing
    leaf = np.zeros((8, 8), np.int64)
    leaf[0, 0], leaf[7, 7] = 3, 2
    assert counts.interaction_pairs(counts.level_counts(leaf, 2),
                                    counts.level_counts(leaf, 2)) == 2
    assert counts.interaction_pairs(leaf, leaf) == 0
    assert counts.level_counts(leaf, 1).tolist() == [[3, 0], [0, 2]]


def test_m2l_counts_on_the_papers_leaf_level():
    n, p = 1024, 17
    full = np.ones((n, n), np.int64)
    w = counts.m2l_level_work(full, full, p)
    # 28,225,596 interaction pairs (27 a box away from the edges) x 17^2
    # complex multiply-adds x 8
    assert w["pairs"] == 28_225_596
    assert w["ops"] == 28_225_596 * 289 * 8 == 65_257_577_952
    # each box's 17 multipole coefficients read, its 17 local ones written
    assert w["bytes"] == 2 * n * n * 17 * 8
    ms = counts.bound_s(w["ops"], w["bytes"], counts.F32_PRODUCT_FLOP_PER_S) * 1e3
    assert ms == pytest.approx(0.39550, rel=1e-4)        # by operations
    # only the boxes that hold points count: points in a quarter of the
    # grid read as a grid of 512 boxes a side
    half = np.zeros((n, n), np.int64)
    half[:512, :512] = 1
    w = counts.m2l_level_work(half, half, p)
    assert w["pairs"] == (6 * 512 - 8) ** 2 - (3 * 512 - 2) ** 2
    assert w["bytes"] == 2 * 512 * 512 * 17 * 8


def test_p2p_counts_on_a_hand_worked_tree():
    src = np.array([[2, 0], [1, 3]])                  # 6 live sources, level 1
    desc = {"equation": "vortex", "level": 1, "p": 4, "singular": False,
            "src_counts": src}
    w = counts.evaluation_work(desc)["p2p"]
    # every box neighbours every other at level 1: 6 x 6 pairs less 6 self pairs
    assert w["pairs"] == 30 and w["ops"] == 30 * 18
    # z and q of the 6 sources read, the 6 targets' velocities written
    assert w["bytes"] == 2 * 8 * 6 + 8 * 6
    tgt = np.array([[1, 1], [0, 2]])
    desc.update(equation="laplace", singular=True, tgt_counts=tgt)
    w = counts.evaluation_work(desc)["p2p"]
    assert w["pairs"] == 4 * 6 and w["ops"] == 24 * 23
    # the sources' z and q, the 4 passive targets' z, two channels out
    assert w["bytes"] == 2 * 8 * 6 + 8 * 4 + 2 * 8 * 4


def test_stage_counts_and_least_time():
    desc = {"equation": "vortex", "level": 3, "p": 5, "singular": True,
            "src_counts": np.ones((8, 8), np.int64)}
    w = counts.evaluation_work(desc)
    assert w["p2m"]["ops"] == 64 * (4 + 6 * 4 + 8 * 5)
    assert w["m2m"]["ops"] == 64 * 15 * 8              # level 3's boxes into level 2
    assert w["l2l"]["ops"] == 64 * 15 * 8
    assert w["m2l"]["ops"] == (156 + 1116) * 25 * 8    # levels 2 and 3, full
    assert [x["level"] for x in w["m2l"]["levels"]] == [2, 3]
    empty = dict(desc, src_counts=np.pad(np.ones((4, 4), np.int64), ((0, 4), (0, 4))))
    w2 = counts.evaluation_work(empty)
    assert w2["m2m"]["ops"] == w2["l2l"]["ops"] == 16 * 15 * 8
    least = counts.least_time_s(w)
    assert least == pytest.approx(sum(v["ops"] / v["rate"] for v in w.values()))
    assert counts.bound_s(10, 3.35e12, 1.0) == 10.0
    assert counts.bound_s(1, 3.35e12, 1.0) == 1.0


def _trace(kernel_s, launches, steps=2):
    desc = {"equation": "vortex", "level": 4, "p": 8, "singular": False,
            "src_counts": np.full((16, 16), 2)}
    return {"stretch": {"steps": steps, "evaluations": [desc] * steps,
                        "launches": launches, "window_s": 1.0},
            "profile": {"busy_s": 0.9, "window_s": 1.0,
                        "kernel_s": {"void p2p_kernel<8>(x)": kernel_s,
                                     "void m2l_kernel<3>(y)": kernel_s}},
            "spans": {}, "step_s": [0.5, 0.5, 0.5, 0.5], "stretch_start": 1,
            "kick_ops_per_step": 0}, desc


def read(name, trace):
    return manifest.load_module(manifest.ROOT, "metrics", name).read(trace)


def test_roofline_readers_divide_the_counted_bound_by_the_kernel_time():
    trace, desc = _trace(1e-3, {"p2p": 2, "m2l": 6})
    w = counts.evaluation_work(desc)
    p2p = counts.bound_s(w["p2p"]["ops"], w["p2p"]["bytes"], w["p2p"]["rate"])
    assert read("p2p_roofline", trace) == pytest.approx(100 * 2 * p2p / 1e-3)
    m2l = sum(counts.bound_s(x["ops"], x["bytes"], x["rate"]) for x in w["m2l"]["levels"])
    assert read("m2l_roofline", trace) == pytest.approx(100 * 2 * m2l / 1e-3)
    assert read("device_idle_share", trace) == pytest.approx(10.0)
    least = counts.least_time_s(w)
    assert read("step_mfu", trace) == pytest.approx(100 * least / 0.5)


def test_readers_return_nothing_when_they_find_nothing_to_read():
    trace, _ = _trace(0.0, {"p2p": 2, "m2l": 6})
    assert read("p2p_roofline", trace) is None          # no kernel time: no share
    trace, _ = _trace(1e-3, {"p2p": 3, "m2l": 6})
    assert read("p2p_roofline", trace) is None          # launches not the evaluations'
    for name in ("rebin_ms", "replan_ms", "expansions_ms", "p2p_roofline",
                 "m2l_roofline", "device_idle_share", "step_mfu"):
        assert read(name, {"spans": {}, "step_s": []}) is None


class _Event:
    def __init__(self, start, end, name, cuda, annotation=False):
        import types
        self.time_range = types.SimpleNamespace(start=start, end=end)
        self.name = name
        self.device_type = (torch.autograd.DeviceType.CUDA if cuda
                            else torch.autograd.DeviceType.CPU)
        self.is_user_annotation = annotation


def test_profile_reader_merges_busy_intervals_and_names_idle_gaps():
    from fmmbench import profiling
    events = [_Event(0, 10, "k1", True), _Event(5, 20, "k2", True), _Event(40, 50, "k1", True),
              _Event(0, 60, "fmmbench.evaluation", True, annotation=True),
              _Event(0, 60, "fmmbench.step", True),
              _Event(0, 100, "fmmbench.evaluation", False, annotation=True),
              _Event(22, 38, "aten::einsum", False)]
    prof = type("P", (), {"events": lambda self: events})()
    got = profiling.read_profile(prof, 1e-4)
    assert got["busy_s"] == pytest.approx(30e-6)             # [0, 20] and [40, 50]
    assert got["kernel_s"] == pytest.approx({"k1": 20e-6, "k2": 15e-6})
    assert got["idle_gaps"] == [["aten::einsum", pytest.approx(20e-6)]]
    assert [n for n, _ in got["device_ops"]] == ["k1", "k2"]
    assert profiling.read_profile(type("P", (), {"events": lambda self: events[-2:]})(), 1.0) is None
