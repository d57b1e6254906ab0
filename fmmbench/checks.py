"""Exact checks of what the timed path produced: rebins, kicks, the start.

Each returns a count of particles that the program got wrong; its limit is
0.  Plain PyTorch on any device; nothing of the program is imported.
"""
from __future__ import annotations

import torch

from fmmbench import reference


def leaves(tree) -> list[torch.Tensor]:
    """The tensors of a nested tuple/list/dict, in a fixed order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def rows(mask: torch.Tensor, values: list[torch.Tensor]) -> torch.Tensor:
    """(live, K) int32 bit patterns of every value at the live slots of
    ``mask`` (a complex value gives two columns)."""
    m = mask.reshape(-1)
    cols = []
    for v in values:
        v = v.reshape(-1)[m]
        parts = (v.real, v.imag) if v.is_complex() else (v,)
        for part in parts:
            part = part.contiguous()
            if part.dtype == torch.float64:
                part = part.view(torch.int64)
            elif part.element_size() == 4:
                part = part.view(torch.int32)
            cols.append(part.to(torch.int64))
    return torch.stack(cols, dim=1)


def lexsort(r: torch.Tensor) -> torch.Tensor:
    """Rows of ``r`` in lexicographic order."""
    idx = torch.arange(r.shape[0], device=r.device)
    for k in range(r.shape[1] - 1, -1, -1):
        idx = idx[torch.argsort(r[idx, k], stable=True)]
    return r[idx]


def multiset_mismatch(a: torch.Tensor, b: torch.Tensor) -> int:
    """Rows by which two multisets of rows differ (0 when equal)."""
    if a.shape != b.shape:
        return abs(a.shape[0] - b.shape[0]) + int(a.shape[1] != b.shape[1]) * a.shape[0]
    return int((lexsort(a) != lexsort(b)).any(dim=1).sum())


def misbinned(z: torch.Tensor, mask: torch.Tensor, level: int) -> int:
    """Live slots of an (n, n, s) tree whose point lies outside its box."""
    n = 1 << level
    ix, iy = reference.boxes(z.reshape(-1), level)
    s = z.shape[-1]
    slot = torch.arange(n * n * s, device=z.device) // s
    wrong = (iy * n + ix != slot) & mask.reshape(-1)
    return int(wrong.sum())


def off_by_more_than_an_ulp(got: torch.Tensor, exact: torch.Tensor,
                            mask: torch.Tensor) -> int:
    """Live slots where a float32 result departs from the exact value by
    more than one float32 unit in the last place in either component."""
    m = mask.reshape(-1)
    got, exact = got.reshape(-1)[m], exact.reshape(-1)[m]
    bad = torch.zeros(got.shape, dtype=torch.bool, device=got.device)
    for g, e in ((got.real, exact.real), (got.imag, exact.imag)):
        e32 = e.to(torch.float32).abs()
        ulp = (torch.nextafter(e32, torch.full_like(e32, float("inf"))) - e32).double()
        bad |= (g.double() - e).abs() > ulp
    return int(bad.sum())
