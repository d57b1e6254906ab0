"""The plain reference against a brute float64 sum, and its TF32 control."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from fmmbench import checks, reference, traffic

LEVEL = 3


def brute(kind, zt, zs, q, sigma, level):
    """Pair by pair in Python floats: the Gaussian core within the 3 x 3
    leaf boxes around the target's box, singular beyond, self left out."""
    n = 1 << level
    box = lambda z: (min(max(int(z.real * n), 0), n - 1), min(max(int(z.imag * n), 0), n - 1))  # noqa: E731
    out = []
    for t in zt:
        bt, pot, field = box(t), 0.0, 0.0
        for s, qj in zip(zs, q):
            d = t - s
            r2 = d.real ** 2 + d.imag ** 2
            if r2 == 0:
                continue
            bs = box(s)
            w = 1.0
            if sigma is not None and abs(bt[0] - bs[0]) <= 1 and abs(bt[1] - bs[1]) <= 1:
                w = 1.0 - np.exp(-r2 / (2 * sigma * sigma))
            pot += qj * 0.5 * np.log(r2) * w
            field += qj / d * w
        out.append(field if kind == "vortex" else (pot, -field))
    return np.array(out)


def points(seed, count):
    g = np.random.default_rng(seed)
    z = (g.random(count) + 1j * g.random(count)).astype(np.complex64)
    return z


@pytest.mark.parametrize("kind,sigma", [("vortex", None), ("vortex", 0.05), ("laplace", None),
                                        ("laplace", 0.05)])
def test_reference_agrees_with_a_brute_float64_sum(kind, sigma):
    zs = points(1, 60)
    q = np.random.default_rng(2).uniform(-1, 1, 60) * (1 if kind == "laplace" else 1 / (2j * np.pi))
    zt = np.concatenate([zs[:7], points(3, 5)])
    got = reference.pair_sum(kind, torch.as_tensor(zt), torch.as_tensor(zs),
                             torch.as_tensor(q), sigma, LEVEL, block=4)
    want = brute(kind, zt.astype(np.complex128), zs.astype(np.complex128), q, sigma, LEVEL)
    assert got.dtype == torch.complex128
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


def test_tf32_drops_the_low_13_mantissa_bits_toward_zero():
    x = torch.tensor([1 + 3 * 2.0 ** -11, -(1 + 3 * 2.0 ** -11), 1 + 2.0 ** -10, 3.0e-5])
    y = reference.tf32(x)
    assert y[0] == 1 + 2.0 ** -10 and y[1] == -(1 + 2.0 ** -10)
    assert y[2] == x[2]
    assert (y.view(torch.int32) & reference.TF32_DROP == 0).all()


def test_control_departs_from_the_reference():
    zs = points(4, 400)
    q = np.random.default_rng(5).uniform(0.5, 1.5, 400) / (2j * np.pi)
    args = (torch.as_tensor(zs[:64]), torch.as_tensor(zs), torch.as_tensor(q), 0.02, 4)
    ref = reference.pair_sum("vortex", *args)
    ctl = reference.pair_sum("vortex", *args, precision="tf32")
    assert ctl.dtype == torch.complex64
    assert 1e-5 < reference.rel_l2(ctl, ref) < 1e-2


def test_generator_is_the_seeds_and_keeps_every_size():
    cfg = {"n_side": 30, "num_particles": 900, "sigma": 0.02, "spacing_ratio": 0.8,
           "extent": 0.8, "level": 5}
    params = {"centre_jitter_boxes": 1.0, "point_jitter": 0.1}
    a, b = traffic.lattice(cfg, params, 2 ** 31 + 5), traffic.lattice(cfg, params, 2 ** 31 + 5)
    c = traffic.lattice(cfg, params, 6)
    assert np.array_equal(a["positions"], b["positions"])
    assert not np.array_equal(a["positions"], c["positions"])
    assert a["positions"].shape == c["positions"].shape == (900, 2)
    assert np.array_equal(a["positions"].astype(np.float32).astype(np.float64), a["positions"])
    assert abs(a["centre"][0] - 0.5) <= 2 ** -5 and a["sigma"] == c["sigma"]
    g = torch.Generator()
    base = torch.ones(10, dtype=torch.float64)
    s1 = traffic.evaluation_strengths({"kind": "uniform", "low": 0.5, "high": 1.5,
                                       "times_base": True}, base, 7, 3, g)
    s2 = traffic.evaluation_strengths({"kind": "uniform", "low": 0.5, "high": 1.5,
                                       "times_base": True}, base, 7, 3, g)
    assert torch.equal(s1, s2) and bool(((s1 >= 0.5) & (s1 < 1.5)).all())


def test_exact_checks_count_what_differs():
    # a level-1 tree, one slot a box, boxes [iy, ix]
    z = torch.tensor([0.1 + 0.1j, 0.2 + 0.1j, 0.6 + 0.1j, 0.7 + 0.7j],
                     dtype=torch.complex64).reshape(2, 2, 1)
    mask = torch.ones(2, 2, 1, dtype=torch.bool)
    assert checks.misbinned(z, mask, 1) == 2            # the middle two sit in other boxes
    mask[0, 1, 0] = False
    assert checks.misbinned(z, mask, 1) == 1
    a = checks.rows(mask, [z])
    assert checks.multiset_mismatch(a, checks.rows(mask, [z])) == 0
    assert checks.multiset_mismatch(a, checks.rows(mask, [z + 1e-3])) == 3
    assert checks.multiset_mismatch(a, a[:2]) == 1
    exact = z.to(torch.complex128)
    assert checks.off_by_more_than_an_ulp(z, exact, mask) == 0
    assert checks.off_by_more_than_an_ulp(z, exact + 1e-6, mask) == 3
