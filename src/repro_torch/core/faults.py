"""Deterministic fault injection for guarded execution.

A :class:`FaultSpec` names one fault SITE, keyed by the 1-based step index
at which it fires; a :class:`FaultInjector` holds a set of specs and is the
only object drivers ever see.  Specs are frozen and hashable, and a step
with no active fault passes the empty tuple, which runs exactly the
injection-free computation.

Sites (where each one lands):

  halo_nan      NaN written into the received ghost strip of the packed P2P
                halo exchange on one device (sharded driver only).
                ``only_grid`` restricts the site to a specific plan grid,
                so a plan-fallback rung can escape it.
  tile_corrupt  one device's output tile made non-finite after the masked
                evaluation (sharded driver only).
  teleport      the slot-0 live particle of every occupied leaf box shifted
                by ``magnitude`` (PHYSICAL units: the stepper rescales by
                its domain size, so root-box expansion can cure a sticky
                teleport whose magnitude fits the grown domain) after the
                first half-kick.
  overflow      every live particle clumped into one leaf box after the
                first half-kick, overflowing its slot capacity.
  time_inflate  one step's measured wall-clock sample multiplied by
                ``magnitude`` (host side; exercises the outlier filter on
                the measured-feedback loop, never the device computation).
  proc_kill     SIGKILL rank ``device`` once its heartbeat reaches step
                ``step`` (supervisor level: the drivers never see it).
  proc_hang     SIGSTOP the same way: the process stays alive but its
                heartbeat goes stale.

Non-sticky specs fire only on attempt 0 of their step, the model of a
transient fault, recovered by the ladder's plain retry.  ``sticky=True``
fires on every attempt, forcing escalation down the ladder (and, when no
rung can dodge the site, the typed ``StepperFaultError``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

DEVICE_SITES = ("halo_nan", "tile_corrupt")
STEP_SITES = ("teleport", "overflow")
HOST_SITES = ("time_inflate",)
PROC_SITES = ("proc_kill", "proc_hang")
SITES = DEVICE_SITES + STEP_SITES + HOST_SITES + PROC_SITES


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    site: str
    step: int                 # 1-based step index at which to fire
    device: int = 0           # target device (device sites)
    sticky: bool = False      # fire on every attempt, not just the first
    magnitude: float = 2.0    # teleport offset / time inflation factor
    only_grid: Optional[tuple[int, int]] = None  # restrict halo_nan to a grid

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r}; "
                             f"one of {SITES}")

    @property
    def rank(self) -> int:
        """Target rank of a process-granularity site (alias of ``device``:
        one spec vocabulary covers both granularities)."""
        return self.device


class FaultInjector:
    """Holds the configured faults; drivers query the active subset."""

    def __init__(self, *specs: FaultSpec):
        self.specs = tuple(specs)

    def active(self, step: int, attempt: int = 0) -> tuple[FaultSpec, ...]:
        """Device-side faults firing at (step, attempt), the tuple handed
        to ``rk2_step``.  Host- and process-level sites never enter it."""
        return tuple(f for f in self.specs
                     if f.step == step and f.site in DEVICE_SITES + STEP_SITES
                     and (f.sticky or attempt == 0))

    def proc_faults(self) -> tuple[FaultSpec, ...]:
        """Process-granularity specs, executed by a kill-drill supervisor
        (never by the drivers)."""
        return tuple(f for f in self.specs if f.site in PROC_SITES)

    def time_factor(self, step: int) -> float:
        """Host-side measured-time inflation factor for this step."""
        factor = 1.0
        for f in self.specs:
            if f.step == step and f.site == "time_inflate":
                factor *= f.magnitude
        return factor


# -- device-side application -------------------------------------------------


def corrupt_halo(buf: torch.Tensor, faults: tuple[FaultSpec, ...],
                 device_index: int, grid: tuple[int, int]) -> torch.Tensor:
    """Apply active ``halo_nan`` specs to an exchanged halo buffer.

    On the target device the first ghost row of the buffer is multiplied
    by NaN (NaN * x = NaN, the zero domain-edge padding included); on the
    others by 1, as the reference does on every device."""
    for f in faults:
        if f.site != "halo_nan":
            continue
        if f.only_grid is not None and tuple(f.only_grid) != tuple(grid):
            continue
        scale = float("nan") if device_index == f.device else 1.0
        buf = buf.clone()
        buf[0] = buf[0] * torch.tensor(scale, dtype=buf.dtype, device=buf.device)
    return buf


def corrupt_tile(out: torch.Tensor, faults: tuple[FaultSpec, ...],
                 device_index: int) -> torch.Tensor:
    """Apply active ``tile_corrupt`` specs to one device's output tile."""
    for f in faults:
        if f.site == "tile_corrupt":
            bad = torch.tensor(float("inf") if device_index == f.device else 0.0,
                               dtype=out.real.dtype, device=out.device)
            # a real term on a complex tile adds to the real part only (a
            # complex inf would make the imaginary part NaN)
            out = (torch.complex(out.real + bad, out.imag + 0.0)
                   if out.is_complex() else out + bad)
    return out


def corrupt_positions(z: torch.Tensor, mask: torch.Tensor,
                      faults: tuple[FaultSpec, ...]) -> torch.Tensor:
    """Apply active ``teleport`` / ``overflow`` specs to mid-step positions
    (the global (n, n, s) position grid inside ``rk2_step``)."""
    for f in faults:
        if f.site == "teleport":
            shift = torch.tensor(f.magnitude * (1.0 + 1.0j), dtype=z.dtype,
                                 device=z.device)
            # slot 0 of every occupied box: nonempty wherever particles are
            sel = torch.zeros_like(mask)
            sel[..., 0] = mask[..., 0]
            z = torch.where(sel, z + shift, z)
        elif f.site == "overflow":
            z = torch.where(mask, torch.tensor(0.5 + 0.5j, dtype=z.dtype,
                                               device=z.device), z)
    return z
