"""Distributed FMM over ``torch.distributed``: the sharded driver of
``src/repro/core/parallel_fmm.py``, one program per rank.

The leaf grid is cut into rank tiles by an execution plan: a 1-D
:class:`~repro_torch.core.plan.SlabPlan` (parity-even row bands) or a 2-D
:class:`~repro_torch.core.plan.BlockPlan` (a ``Pr x Pc`` grid of
parity-even tiles).  Both run through ONE body: a slab is the ``Pr x 1``
block (``SlabPlan.as_block``).  Rank ``d = i * Pc + j`` owns tile
``(i, j)``.  Levels deep enough that tile boundaries stay aligned are
sharded the same way; the coarser levels form the root tree, replicated on
every rank from one ``all_gather`` at the cut level.

Messages (the paper's Fig 3):
  * M2M / L2L: subtree <-> root tree only, through the cut-level gather,
    reassembled across unequal tiles by the plan's owner maps;
  * M2L: a ±2-line halo of each sharded level from the neighbour tiles;
  * P2P: a ±1-line halo of (z, q, mask), packed into one buffer of 4 or 5
    f32 planes so it crosses in one exchange (``_pack_particles``).

The two-axis exchange runs columns first, then the rows of the
column-extended strips, so the corner (diagonal) ghosts ride along.  Each
phase is one ``batch_isend_irecv`` over the neighbour pairs; a rank-grid
axis of one rank issues nothing.  The row phase needs the column phase's
strips, so a block plan's column phase completes when the exchange is
issued and only its row phase stays in flight.

``overlap=True`` issues every exchange before the compute that can hide it
(the P2P exchange before the upward sweep, each sharded level's M2L
exchange before the root tree) and waits for a buffer only when the rim
strips along the tile edges need it, after the tile interior's launch
(``fmm.m2l_tile_overlapped`` / ``fmm.p2p_tile_overlapped``).
``overlap=False`` waits for each exchange as soon as it is issued and runs
one slab over the whole halo'd tile.  The two agree to f32 roundoff.
``pipeline=True`` computes every sharded level's M2L before the first use
of the cut-level gather; ``pipeline=False`` uses it first.  The two run the
same operations on the same inputs and agree bit for bit.

On a ``gloo`` group every message is staged through host memory
(``launch/mesh.py``); the kernels stay on the card.  M2L and P2P are the
serial driver's slab functions (``fmm.m2l_slab_fn`` / ``fmm.p2p_slab_fn``):
the CUDA kernels for CUDA tensors, their plain versions on the CPU.
"""
from __future__ import annotations

import functools
from typing import Optional, Union

import torch
import torch.nn.functional as F

from ..configs.backend import check_on
from ..launch.mesh import Pending, RankMesh, make_local_mesh
from . import equations as eqs
from . import expansions as ex
from . import faults as flt
from . import fmm
from . import health as hw
from .plan import BlockPlan, SlabPlan, uniform_plan
from .quadtree import Tree, box_size


class _Deferred(Pending):
    """A halo buffer that an exchange in flight will complete: ``wait()``
    assembles it once; its ``shape`` is known up front."""

    def __init__(self, finish, shape):
        super().__init__([], finish, [])
        self.shape = tuple(shape)


def _tile_halo(x: torch.Tensor, width: int, rows_valid: int, cols_valid: int,
               mesh: RankMesh, grid: tuple[int, int]) -> _Deferred:
    """Attach ±``width`` ghost rows AND columns at the valid tile edges.

    ``x`` is this rank's (rows_max, cols_max, ...) padded tile, valid in
    rows ``[0, rows_valid)`` and columns ``[0, cols_valid)``, padding zero.
    The buffer is (rows_max + 2w, cols_max + 2w, ...): the tile at offset
    ``(w, w)``, the upper/left neighbour's strips at offset 0 and the
    lower/right one's at ``w + rows_valid`` / ``w + cols_valid``; a domain
    edge gets zeros.  Columns are exchanged first and the row strips cut
    from the column-extended tile, so the corners ride along.  An axis of
    one rank exchanges nothing, and with one column band the rows go at
    raw width ``cols_max``, the 2w extra columns being known zeros.
    """
    Pr, Pc = grid
    w = width
    rmax, cmax = x.shape[0], x.shape[1]
    trail = tuple(x.shape[2:])
    d = mesh.rank
    j = d % Pc
    # -- phase 1: columns (east/west neighbours own my exact row range) -----
    if Pc > 1:
        sends, recvs, where = [], [], []
        if j + 1 < Pc:       # my right edge -> the east neighbour's left halo
            sends.append((d + 1, x[:, cols_valid - w:cols_valid]))
            recvs.append((d + 1, (rmax, w) + trail, x.dtype))
            where.append(w + cols_valid)
        if j > 0:            # my left edge -> the west neighbour's right halo
            sends.append((d - 1, x[:, :w]))
            recvs.append((d - 1, (rmax, w) + trail, x.dtype))
            where.append(0)
        got = mesh.exchange(sends, recvs).wait()
        xc = x.new_zeros((rmax, cmax + 2 * w) + trail)
        xc[:, w:w + cmax] = x
        for c0, strip in zip(where, got):
            xc[:, c0:c0 + w] = strip
        c0 = 0
    else:
        xc, c0 = x, w
    # -- phase 2: rows of the column-extended strips (corners ride along) ---
    xw = xc.shape[1]
    rows = None
    if Pr > 1:
        sends, recvs, where = [], [], []
        if d + Pc < Pr * Pc:     # my bottom edge -> the south neighbour's top
            sends.append((d + Pc, xc[rows_valid - w:rows_valid]))
            recvs.append((d + Pc, (w, xw) + trail, x.dtype))
            where.append(w + rows_valid)
        if d >= Pc:              # my top edge -> the north neighbour's bottom
            sends.append((d - Pc, xc[:w]))
            recvs.append((d - Pc, (w, xw) + trail, x.dtype))
            where.append(0)
        rows = mesh.exchange(sends, recvs)

    def finish():
        buf = x.new_zeros((rmax + 2 * w, cmax + 2 * w) + trail)
        buf[w:w + rmax, c0:c0 + xw] = xc
        if rows is not None:
            for r0, strip in zip(where, rows.wait()):
                buf[r0:r0 + w, c0:c0 + xw] = strip
        return buf
    return _Deferred(finish, (rmax + 2 * w, cmax + 2 * w) + trail)


def _pack_particles(z, q, mask, q_real: bool = False) -> torch.Tensor:
    """Stack (z, q, mask) into ONE real (rows, cols, planes, s) buffer, so
    the P2P halo crosses in one exchange: planes [Re z, Im z, Re q, Im q,
    mask] (5), or [Re z, Im z, Re q, mask] (4) for an equation whose
    charges are real (``q_is_real``).  f32 carries the complex64 parts and
    the mask exactly, so the round trip is lossless."""
    planes = [z.real, z.imag, q.real]
    if not q_real:
        planes.append(q.imag)
    planes.append(mask.to(torch.float32))
    return torch.stack(planes, dim=2)


def _unpack_particles(buf: torch.Tensor, q_real: bool = False):
    """Inverse of :func:`_pack_particles` (on an exchanged, halo'd buffer)."""
    z = torch.complex(buf[:, :, 0], buf[:, :, 1])
    if q_real:
        q = torch.complex(buf[:, :, 2], torch.zeros_like(buf[:, :, 2]))
        m = buf[:, :, 3] > 0.5
    else:
        q = torch.complex(buf[:, :, 2], buf[:, :, 3])
        m = buf[:, :, 4] > 0.5
    return z, q, m


def _real_charges(q: torch.Tensor) -> torch.Tensor:
    return torch.complex(q.real, torch.zeros_like(q.real))


def _tile_extents(plan: BlockPlan, rank: int) -> tuple[int, int, int, int]:
    """``(row0, rows, col0, cols)`` of rank ``rank``'s tile."""
    i, j = divmod(rank, plan.grid[1])
    return plan.row0[i], plan.rows[i], plan.col0[j], plan.cols[j]


def _parallel_fmm_body(z, q, mask, zt, mt, p2p_pre, *, plan: BlockPlan,
                       l_cut: int, p: int, sigma, mesh: RankMesh,
                       overlap: bool, eq, pipeline: bool,
                       with_health: bool, faults: tuple):
    """Runs on each rank over its padded (rows_max, cols_max, s) tile.

    ``p2p_pre`` is the P2P halo buffer that
    :func:`parallel_fmm_p2p_prefetch` already issued, or None to issue it
    here; the fault injection and the health sentinel apply to it either
    way.  ``zt``/``mt`` are passive targets' tiles (None: the sources).
    Returns the (rows_max, cols_max, s|st[, C]) output tile and this
    rank's health word (None without ``with_health``).
    """
    L = plan.level
    grid = plan.grid
    rows_max, cols_max = plan.rows_max, plan.cols_max
    row0, rows, col0, cols = _tile_extents(plan, mesh.rank)
    if eq.q_is_real:
        # the packed halo drops the Im q plane; project the local charges
        # too so interior and rim read the same data
        q = _real_charges(q)
    m2l_slab = fmm.m2l_slab_fn(p, eq)
    m2l_grid = fmm.m2l_grid_fn(p, eq)
    p2p_slab = fmm.p2p_slab_fn(eq)
    bad = []                       # 0/1 sentinels of the exchanged buffers

    def halo(x, width, rv, cv):
        return _tile_halo(x, width, rv, cv, mesh, grid)

    # ---- P2P halo: one packed exchange, issued first ------------------------
    p2p_pending = p2p_pre if p2p_pre is not None else halo(
        _pack_particles(z, q, mask, eq.q_is_real), 1, rows, cols)
    p2p_bufs = []

    def p2p_ready():
        if not p2p_bufs:
            buf = flt.corrupt_halo(p2p_pending.wait(), faults, mesh.rank, grid)
            if with_health:
                bad.append(hw.nonfinite(buf))
            p2p_bufs.extend(_unpack_particles(buf, eq.q_is_real))
        return p2p_bufs
    if not overlap:
        p2p_ready()

    cen = F.pad(fmm._centers_on(L, z.device), (0, cols_max, 0, rows_max))
    my_centers = cen[row0:row0 + rows_max, col0:col0 + cols_max]

    # ---- upward sweep (padding has mask=False: its MEs stay zero) ---------
    mop = ex.device_operator(eq.m2m_operator, p, z.device)
    me = {L: ex.p2m(z, q, mask, my_centers, box_size(L), p,
                    coeff=eq.p2m_coeff(p))}
    for lv in range(L, l_cut, -1):
        me[lv - 1] = ex.m2m(me[lv], p, op=mop)

    def me_halo(lv):
        shift = L - lv
        pending = halo(me[lv], ex.M2L_HALO, rows >> shift, cols >> shift)

        def ready():
            buf = pending.wait()
            if with_health:
                bad.append(hw.nonfinite(buf))
            return buf
        return ready

    # overlap: issue every sharded level's M2L exchange now
    me_bufs = ({lv: me_halo(lv) for lv in range(l_cut + 1, L + 1)}
               if overlap else {})
    # the cut level to every rank: the replicated root tree
    gathered = mesh.all_gather(me[l_cut])

    def sharded_m2l(lv):
        shift = L - lv
        rv, cv = rows >> shift, cols >> shift
        if overlap:
            return fmm.m2l_tile_overlapped(m2l_slab, me[lv], me_bufs[lv], lv,
                                           rv, cv)
        return m2l_slab(me_halo(lv)(), lv, col_halo=ex.M2L_HALO)

    # pipeline: every sharded level's M2L before the gather's first use
    le_m2l = ({lv: sharded_m2l(lv) for lv in range(l_cut + 1, L + 1)}
              if pipeline else {})

    cut_shift = L - l_cut
    owner, loc_r, loc_c = _owner_maps(plan, cut_shift, z.device)
    me_rep = {l_cut: gathered.wait()[owner, loc_r, loc_c]}
    for lv in range(l_cut, 2, -1):
        me_rep[lv - 1] = ex.m2m(me_rep[lv], p, op=mop)

    # ---- downward sweep ----------------------------------------------------
    le_rep: dict[int, torch.Tensor] = {}
    for lv in range(2, l_cut + 1):
        le_rep[lv] = m2l_grid(me_rep[lv], lv)
        if lv > 2:
            le_rep[lv] = le_rep[lv] + ex.l2l(le_rep[lv - 1], p)

    def slice_tile(grid_lv, shift):
        """My padded tile out of a replicated level grid."""
        rmax, cmax = rows_max >> shift, cols_max >> shift
        padded = F.pad(grid_lv, (0, 0, 0, cmax, 0, rmax))
        r, c = row0 >> shift, col0 >> shift
        return padded[r:r + rmax, c:c + cmax]

    le_prev = slice_tile(le_rep[l_cut], cut_shift)
    for lv in range(l_cut + 1, L + 1):
        le_lv = le_m2l[lv] if pipeline else sharded_m2l(lv)
        le_prev = le_lv + ex.l2l(le_prev, p)
    le_leaf = le_prev

    # ---- evaluation --------------------------------------------------------
    far = ex.l2p_eval(le_leaf, z if zt is None else zt, my_centers,
                      box_size(L), p, eq.l2p_modes)
    if overlap:
        near = fmm.p2p_tile_overlapped(p2p_slab, z, q, mask, p2p_ready, rows,
                                       cols, sigma, z_tgt=zt, mask_tgt=mt)
    else:
        near = p2p_slab(*p2p_ready(), sigma, zt, mt)
    out_mask = mask if mt is None else mt
    out = fmm._mask_channels(out_mask, far + near)
    out = flt.corrupt_tile(out, faults, mesh.rank)
    if not with_health:
        return out, None
    health = hw.empty(z.device)
    health = hw.with_flag(health, hw.F_HALO, torch.stack(bad).max())
    health = hw.with_flag(health, hw.F_COEFF,
                          torch.maximum(hw.nonfinite(me[L]),
                                        hw.nonfinite(le_leaf)))
    health = hw.with_flag(health, hw.F_VEL, hw.nonfinite(out, out_mask))
    return out, health


# The index maps of the last few plans, on the device: a re-planning
# stepper moves between a handful, and each map of the paper's level-10
# grid takes megabytes there.
@functools.lru_cache(maxsize=8)
def _owner_maps(plan: BlockPlan, shift: int, device: torch.device):
    return tuple(torch.as_tensor(a, device=device)
                 for a in plan.tile_maps(shift))


@functools.lru_cache(maxsize=8)
def _gather_index(plan: BlockPlan, rank: int, device: torch.device):
    """Rank ``rank``'s slice of the plan's gather maps, on ``device``."""
    src_r, src_c, valid = plan.gather_index()
    sl = slice(rank * plan.rows_max, (rank + 1) * plan.rows_max)
    return (torch.as_tensor(src_r[sl], device=device),
            torch.as_tensor(src_c[sl], device=device),
            torch.as_tensor(valid[sl], device=device)[:, :, None])


@functools.lru_cache(maxsize=8)
def _scatter_index(plan: BlockPlan, device: torch.device):
    return tuple(torch.as_tensor(a, device=device)
                 for a in plan.scatter_index())


def _is_identity(plan: BlockPlan, nparts: int, n: int) -> bool:
    """The plan's padded tiles are the standard layout's row bands."""
    return plan.grid[1] == 1 and plan.is_uniform and nparts * plan.rows_max == n


def _my_tile(a: torch.Tensor, plan: BlockPlan, rank: int, identity: bool,
             fill=0) -> torch.Tensor:
    """This rank's padded tile of the (n, n, s) array ``a``, in a new
    allocation (the kernels take aligned inputs)."""
    if identity:
        return fmm._fresh(a[rank * plan.rows_max:(rank + 1) * plan.rows_max])
    src_r, src_c, v = _gather_index(plan, rank, a.device)
    return torch.where(v, a[src_r, src_c], fill)


def _mesh_and_block(mesh: Optional[RankMesh], plan, level: int, device):
    """The mesh (None: a world of one on ``device``) and the plan as a
    block (None: the uniform slab), checked against each other."""
    if mesh is None:
        mesh = make_local_mesh(device=device)
    P_ = mesh.shape[mesh.axis]
    if plan is None:
        plan = uniform_plan(level, P_)
    if plan.level != level:
        raise ValueError(f"plan level {plan.level} != tree level {level}")
    if plan.nparts != P_:
        raise ValueError(f"plan has {plan.nparts} bands for {P_} devices")
    return mesh, plan.as_block() if isinstance(plan, SlabPlan) else plan


def kernel_launches(plan: Union[SlabPlan, BlockPlan],
                    overlap: bool = True) -> dict[str, int]:
    """P2P and M2L slab calls (kernel launches on the card) that one
    evaluation makes on each rank under ``plan``.  The root tree makes one
    M2L a level 2..l_cut; under ``overlap`` a sharded level makes four rim
    M2Ls, plus one for the interior where the level's padded tile exceeds
    ``2 * M2L_HALO`` on both axes, and the near field four rim P2Ps plus
    the interior's; the monolithic order makes one of each a level."""
    block = plan.as_block() if isinstance(plan, SlabPlan) else plan
    L = block.level
    l_cut = L - block.sharded_depth()
    w = ex.M2L_HALO
    m2l = l_cut - 1
    for lv in range(l_cut + 1, L + 1):
        shift = L - lv
        inner = (block.rows_max >> shift) > 2 * w and (block.cols_max >> shift) > 2 * w
        m2l += 4 + inner if overlap else 1
    inner = block.rows_max > 2 and block.cols_max > 2
    return {"p2p": 4 + inner if overlap else 1, "m2l": m2l}


def parallel_fmm_evaluate(tree: Tree, p: int, mesh: Optional[RankMesh] = None,
                          plan: Optional[Union[SlabPlan, BlockPlan]] = None,
                          overlap: bool = True, eq=None,
                          targets: Optional[Tree] = None,
                          with_health: bool = False, faults: tuple = (),
                          pipeline: bool = True, p2p_halo=None, device=None):
    """Distributed FMM evaluation of a registered equation, plan-driven.

    Every rank holds the whole ``tree`` and returns the whole result in the
    standard layout: it cuts its tile out by the plan's gather maps, runs
    the body, and all-gathers the output tiles.  ``plan`` (None: the
    uniform slab) maps ranks to parity-even row bands (:class:`SlabPlan`)
    or tiles (:class:`BlockPlan`); the result does not depend on it beyond
    f32 roundoff.  ``mesh=None`` is a world of one on ``device`` (None: the
    CUDA card), with no collective; a mesh brings its own device.

    ``eq`` selects the equation (vortex by default); ``targets``, a second
    :class:`Tree` at the same level, holds passive targets cut by the same
    plan, and the output is then per target slot, (n, n, st[, eq.nout]).
    ``with_health=True`` returns ``(out, health)``: the ranks' health
    words (non-finite sentinels on the exchanged buffers, the expansion
    coefficients and the masked output) combined over all of them.
    ``faults`` is the tuple of active
    :class:`~repro_torch.core.faults.FaultSpec`s; ``overlap`` and
    ``pipeline`` order the work as the module docstring says.
    ``p2p_halo`` is this rank's P2P halo buffer from
    :func:`parallel_fmm_p2p_prefetch`, consumed in place of an exchange.
    """
    eq = eqs.get_equation(eq)
    if tree.level < 2:
        raise ValueError("parallel FMM requires tree level >= 2")
    if targets is None and eq.needs_targets:
        raise ValueError(f"equation {eq.name!r} requires a targets tree")
    if targets is not None and targets.level != tree.level:
        raise ValueError("targets tree level != source tree level")
    mesh, block = _mesh_and_block(mesh, plan, tree.level, device)
    check_on(mesh.device, tree.z, tree.q, tree.mask)
    if targets is not None:
        check_on(mesh.device, targets.z, targets.mask)
    rank, P_ = mesh.rank, mesh.shape[mesh.axis]
    rows_max, cols_max = block.rows_max, block.cols_max
    if p2p_halo is not None:
        planes = 4 if eq.q_is_real else 5
        want = (rows_max + 2, cols_max + 2, planes, tree.slots)
        if tuple(p2p_halo.shape) != want:
            raise ValueError(f"p2p_halo shape {tuple(p2p_halo.shape)} does "
                             f"not match plan/equation (expected {want})")
        if isinstance(p2p_halo, torch.Tensor):
            p2p_halo = _Deferred(lambda t=p2p_halo: t, p2p_halo.shape)

    identity = _is_identity(block, P_, tree.nside)
    z = _my_tile(tree.z, block, rank, identity)
    q = _my_tile(tree.q, block, rank, identity)
    m = _my_tile(tree.mask, block, rank, identity, fill=False)
    zt = mt = None
    if targets is not None:
        zt = _my_tile(targets.z, block, rank, identity)
        mt = _my_tile(targets.mask, block, rank, identity, fill=False)

    out, health = _parallel_fmm_body(
        z, q, m, zt, mt, p2p_halo, plan=block,
        l_cut=block.level - block.sharded_depth(), p=p, sigma=tree.sigma,
        mesh=mesh, overlap=overlap, eq=eq, pipeline=pipeline,
        with_health=with_health, faults=tuple(faults))
    gathered = mesh.all_gather(out)
    words = mesh.all_gather(health) if with_health else None
    w = gathered.wait()
    w = w.reshape((P_ * rows_max,) + tuple(w.shape[2:]))
    if not identity:
        sct_r, sct_c = _scatter_index(block, w.device)
        w = w[sct_r, sct_c]
    if not with_health:
        return w
    return w, hw.device_combine(words.wait())


def parallel_fmm_p2p_prefetch(tree: Tree, mesh: Optional[RankMesh] = None,
                              plan: Optional[Union[SlabPlan, BlockPlan]] = None,
                              eq=None, device=None) -> _Deferred:
    """Issue ONLY the packed (z, q, mask) P2P halo exchange of ``tree``.

    The stepper calls this as soon as the next evaluation's tree exists and
    hands the result to :func:`parallel_fmm_evaluate` as ``p2p_halo``,
    which waits for it at its first use instead of exchanging again.  The
    bytes are the inline round's; fault injection and the health sentinel
    apply at the consumer.  Returns this rank's buffer, (rows_max + 2,
    cols_max + 2, planes, slots), as a deferred value (``.wait()``).
    """
    eq = eqs.get_equation(eq)
    mesh, block = _mesh_and_block(mesh, plan, tree.level, device)
    check_on(mesh.device, tree.z, tree.q, tree.mask)
    identity = _is_identity(block, mesh.shape[mesh.axis], tree.nside)
    z = _my_tile(tree.z, block, mesh.rank, identity)
    q = _my_tile(tree.q, block, mesh.rank, identity)
    m = _my_tile(tree.mask, block, mesh.rank, identity, fill=False)
    if eq.q_is_real:
        q = _real_charges(q)
    _, rows, _, cols = _tile_extents(block, mesh.rank)
    return _tile_halo(_pack_particles(z, q, m, eq.q_is_real), 1, rows, cols,
                      mesh, block.grid)


# The sharded driver's entry points by name, for the static-analysis layer
# (``analysis/``: trace contracts, the collective-schedule verifier).
TRACE_ENTRY_POINTS = {
    "parallel_fmm_evaluate": parallel_fmm_evaluate,
    "parallel_fmm_p2p_prefetch": parallel_fmm_p2p_prefetch,
}


def parallel_fmm_velocity(tree: Tree, p: int, mesh: Optional[RankMesh] = None,
                          plan: Optional[Union[SlabPlan, BlockPlan]] = None,
                          overlap: bool = True, with_health: bool = False,
                          faults: tuple = (), pipeline: bool = True,
                          p2p_halo=None, device=None):
    """Complex velocity W per slot: the vortex form of
    :func:`parallel_fmm_evaluate`."""
    return parallel_fmm_evaluate(tree, p, mesh, plan, overlap, eq=eqs.VORTEX,
                                 with_health=with_health, faults=faults,
                                 pipeline=pipeline, p2p_halo=p2p_halo,
                                 device=device)
