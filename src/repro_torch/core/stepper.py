"""Vortex time stepping: one RK2 (midpoint) step on one device.

``rk2_step`` runs the FMM velocity, the half kick, a device-side rebin
(``quadtree.rebuild_tree``), the second FMM, the full kick and a second
rebin, with no host round trip inside the step.
"""
from __future__ import annotations

import torch

from ..configs.backend import check_on, resolve_device
from . import health as hw
from .fmm import fmm_velocity
from .quadtree import Tree, rebuild_tree


def rk2_step(tree: Tree, dt: float, payload=None, *, p: int,
             guard: bool = False, device=None):
    """One RK2 midpoint step; ``dz/dt = conj(W)`` (W = u - iv).

    ``payload`` is an optional tensor or nested tuple/list/dict of per-slot
    (n, n, s) tensors carried through both rebinnings.  ``device`` (None:
    the CUDA card) must hold the tree.  Returns ``(new_tree, new_payload,
    ok, occ, health)`` as device tensors: ``ok`` is False iff a leaf box
    overflowed its slots during either rebin and ``occ`` is the maximum
    leaf occupancy after the step.  ``guard=True`` also assembles the
    ``core/health.py`` word (driver sentinels, out-of-domain counts taken
    BEFORE the rebins clamp, dropped-particle count, the overflow bit and
    occupancy); ``guard=False`` returns ``health=None``.
    """
    dev = resolve_device(device)
    check_on(dev, tree.z, tree.q, tree.mask)
    v1 = fmm_velocity(tree, p, with_health=guard, device=dev)
    w1, h1 = v1 if guard else (v1, None)
    z_mid = torch.where(tree.mask, tree.z + 0.5 * dt * torch.conj(w1), tree.z)
    live0 = tree.mask.sum()
    aux = (tree.z, payload) if payload is not None else (tree.z,)
    t_mid, aux, ok1 = rebuild_tree(tree, z_mid, aux=aux)
    z0 = aux[0]
    ood1 = hw.out_of_domain_count(z_mid, tree.mask) if guard else None

    v2 = fmm_velocity(t_mid, p, with_health=guard, device=dev)
    w2, h2 = v2 if guard else (v2, None)
    z_new = torch.where(t_mid.mask, z0 + dt * torch.conj(w2), t_mid.z)
    ood2 = hw.out_of_domain_count(z_new, t_mid.mask) if guard else None
    t_new, aux, ok2 = rebuild_tree(t_mid, z_new,
                                   aux=aux[1] if payload is not None else None)
    occ = t_new.mask.sum(dim=-1).max()
    health = None
    if guard:
        health = hw.merge(h1, h2)
        health = hw.with_count(health, hw.F_OOD, ood1 + ood2)
        # a rebin drop is live particles lost to capacity overflow
        health = hw.with_count(health, hw.F_DROPPED, live0 - t_new.mask.sum())
        health = hw.with_flag(health, hw.F_OVERFLOW, ~(ok1 & ok2))
        health = hw.with_flag(health, hw.F_OCC, occ)
    return t_new, aux, ok1 & ok2, occ, health
