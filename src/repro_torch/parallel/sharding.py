"""Sharding rules: which block of each parameter and activation a rank of a
``(pod, data, model)`` grid holds.

The port's counterpart of ``src/repro/parallel/sharding.py``, rule for
rule:

* DP/FSDP: the batch over ``("pod", "data")``; parameters over ``"data"``
  (and ``"pod"`` too, full FSDP, where the dim divides);
* TP: attention heads, FFN hidden and vocab over ``"model"``;
* EP: MoE experts over ``"model"``;
* SP: a decode KV cache over ``"model"`` on its sequence when its KV heads
  do not divide the model axis.

A dim that does not divide its axes falls back to replication on that dim.

A spec is a tuple with one entry a dim: None (replicated), an axis name, or
a tuple of names (the first major): ``PartitionSpec`` without JAX.  A
``mesh`` is anything with ``axis_names`` and a ``shape`` dict, a
:class:`~repro_torch.launch.mesh.GridMesh` or an :class:`AbstractGrid`.
Nothing reshards in the port: there is no compiler to move a tensor from
one layout to another, so each rank holds its block as the spec gives it
(:func:`local_block`), and every collective that GSPMD inserts in the
reference is written out where it is needed (:func:`gather_full`,
``models/moe.py``, ``train/loop.py``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

__all__ = ["BATCH_AXES", "FSDP_AXIS", "TP_AXIS", "AbstractGrid", "batch_axes",
           "axis_size", "param_spec", "param_specs", "batch_spec",
           "activation_spec", "kv_cache_spec", "cache_spec", "constrain", "spec_axes",
           "normalize_spec", "counted_once",
           "block_shape", "local_block", "gather_full", "flat_names"]

BATCH_AXES = ("pod", "data")     # logical data-parallel axes
FSDP_AXIS = "data"
TP_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class AbstractGrid:
    """A grid's axes and sizes, no ranks: ``AbstractMesh`` for the rules."""

    dims: tuple
    axis_names: tuple

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        return math.prod(self.dims)


def batch_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in BATCH_AXES if a in mesh.axis_names)


def axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


def _maybe(mesh, dim: int, axes) -> Optional[object]:
    """Return ``axes`` if ``dim`` divides their product, else None."""
    return axes if dim % axis_size(mesh, axes) == 0 else None


def param_spec(mesh, name: str, shape: tuple[int, ...]) -> tuple:
    """The spec of a parameter by convention on its name and rank.

    Conventions (the leaf's path contains):
      'embed'   (V, D): vocab over TP, D over FSDP
      'w_q','w_in','w_gate'  (D, X): D over FSDP, X over TP
      'w_o','w_out'          (X, D): X over TP, D over FSDP
      'experts'              (E, D, F) / (E, F, D): E over TP (= EP), D over FSDP
      bias/scale 1-D: replicated

    Parameters under a scanned layer stack ('groups/...') carry a leading
    (L,) dim: the rule applies to shape[1:], L stays unsharded.  The port's
    layers are ``layers/<i>/...`` with no such dim.
    """
    shape = tuple(shape)
    if "groups" in name and len(shape) >= 2:
        inner = param_spec(mesh, name.replace("groups", "_g_"), shape[1:])
        return (None, *inner)
    dp = batch_axes(mesh)
    if len(shape) <= 1:
        return ()
    if "router" in name:
        return (None,) * len(shape)
    if "experts" in name:
        # EP over model on the expert dim + FSDP on dim 1 over every data
        # axis that divides (the MoE layer all-gathers dim 1 per layer)
        e_ax = _maybe(mesh, shape[0], TP_AXIS)
        d_ax = _maybe(mesh, shape[1], dp) or _maybe(mesh, shape[1], FSDP_AXIS)
        return (e_ax, d_ax, *([None] * (len(shape) - 2)))
    if "embed" in name or "lm_head" in name:
        v_ax = _maybe(mesh, shape[0], TP_AXIS)
        d_ax = _maybe(mesh, shape[1], FSDP_AXIS)
        return (v_ax, d_ax)
    if any(k in name for k in ("w_o", "w_out", "out_proj")):
        x_ax = _maybe(mesh, shape[0], TP_AXIS)
        d_ax = _maybe(mesh, shape[1], FSDP_AXIS)
        return (x_ax, d_ax)
    if len(shape) == 2:
        # default input-proj convention (D, X)
        d_ax = _maybe(mesh, shape[0], FSDP_AXIS)
        x_ax = _maybe(mesh, shape[1], TP_AXIS)
        return (d_ax, x_ax)
    return (None,) * len(shape)


def flat_names(tree, prefix: str = "") -> list[tuple[str, object]]:
    """``(name, leaf)`` of every tensor of a nested dict/list, in
    ``param_tensors``' order, named by their path (``layers/0/attn/w_q``)."""
    if isinstance(tree, torch.Tensor) or hasattr(tree, "shape"):
        return [(prefix, tree)]
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = []
    for k, v in items:
        out.extend(flat_names(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def param_specs(mesh, params) -> list[tuple]:
    """The spec of every parameter, in ``param_tensors``' order: the
    counterpart of ``param_shardings``.  ``params`` holds the full
    parameters or tensors of their shapes (the meta device will do)."""
    return [param_spec(mesh, name, tuple(t.shape)) for name, t in flat_names(params)]


def batch_spec(mesh, rank: int = 2) -> tuple:
    """Tokens/labels (B, T, ...) -> batch over dp axes."""
    return (batch_axes(mesh), *([None] * (rank - 1)))


def activation_spec(mesh) -> tuple:
    """Hidden states (B, T, D)."""
    return (batch_axes(mesh), None, None)


def kv_cache_spec(mesh, num_kv_heads: int, batch: int) -> tuple:
    """KV cache (B, Hkv, S, d): B over dp; Hkv over TP if it divides, else
    the sequence dim over TP (SP decode, flash-decoding style)."""
    dp = batch_axes(mesh)
    b_ax = dp if batch % axis_size(mesh, dp) == 0 else None
    if num_kv_heads % axis_size(mesh, TP_AXIS) == 0:
        return (b_ax, TP_AXIS, None, None)
    return (b_ax, None, TP_AXIS, None)


def cache_spec(mesh, name: str, shape) -> tuple:
    """The spec of one decode-cache leaf by its role, the reference's
    ``dryrun.py:cache_shardings``: ``k``/``v`` (B, Hkv, S, d) as
    :func:`kv_cache_spec` gives them (heads over the model axis where they
    divide it, else the sequence); ``pos`` replicated; ``ssm`` (B, H, P, N)
    its heads over the model axis, ``h`` (B, W) its width, ``conv`` (B, dc,
    ch) its channels, each where it divides; the batch over the batch axes
    where it divides.  Leading dims (a stacked layer dim) stay whole."""
    shape = tuple(shape)
    dp = batch_axes(mesh)
    if name.endswith(("/k", "/v")):
        base = kv_cache_spec(mesh, shape[-3], shape[-4])
    elif name.endswith("/pos"):
        base = (None,)
    elif name.endswith("/ssm"):
        base = (_maybe(mesh, shape[-4], dp), _maybe(mesh, shape[-3], TP_AXIS), None, None)
    elif name.endswith("/h"):
        base = (_maybe(mesh, shape[-2], dp), _maybe(mesh, shape[-1], TP_AXIS))
    elif name.endswith("/conv"):
        base = (_maybe(mesh, shape[-3], dp), None, _maybe(mesh, shape[-1], TP_AXIS))
    else:
        base = (None,) * len(shape)
    base = tuple(e or None for e in base)       # no batch axis: replicated
    return (None,) * (len(shape) - len(base)) + base


def spec_axes(entry) -> tuple:
    """The axes of one entry of a spec, as a tuple (() for None)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def counted_once(mesh, spec) -> bool:
    """Whether this rank adds its block of a leaf under ``spec`` to a sum
    over the whole grid that must count every element once: a leaf
    replicated over an axis counts on the ranks at index 0 there only."""
    used = {a for e in spec for a in spec_axes(e)}
    return all(mesh.axis_index(a) == 0 for a in mesh.axis_names if a not in used)


def normalize_spec(spec, mesh) -> tuple:
    """``spec`` with the axes of one rank left out of every entry (an entry
    left with none becomes None): two specs that give the same blocks
    normalize alike."""
    out = []
    for entry in spec:
        axes = tuple(a for a in spec_axes(entry) if mesh.shape[a] > 1)
        out.append(axes or None)
    return tuple(out)


def block_shape(mesh, spec, shape) -> tuple:
    """The shape of a rank's block of a tensor of ``shape`` under ``spec``."""
    out = list(shape)
    for d, entry in enumerate(spec):
        out[d] //= axis_size(mesh, spec_axes(entry) or None)
    return tuple(out)


def constrain(x, mesh, spec, full_shape):
    """``with_sharding_constraint``'s place in the port.  The reference
    asks its compiler to move ``x`` into the layout ``spec`` gives; the port
    has no compiler and nothing reshards, so a rank's ``x`` must already be
    its block of a tensor of ``full_shape``.  A one-rank grid returns ``x``;
    otherwise ``x`` is returned as it is when its shape is that block's,
    and anything else raises."""
    if mesh.size == 1:
        return x
    want = block_shape(mesh, tuple(spec) + (None,) * (len(full_shape) - len(spec)),
                       full_shape)
    if tuple(x.shape) != want:
        raise ValueError(f"{tuple(x.shape)} is not a block {want} of "
                         f"{tuple(full_shape)} under {spec}")
    return x


def local_block(full: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of ``full`` under ``spec`` (a view; each dim split
    in equal parts over its axes, in the axes' order)."""
    out = full
    for d, entry in enumerate(spec):
        axes = spec_axes(entry)
        n = axis_size(mesh, axes or None)
        if n == 1:
            continue
        if out.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(full.shape)} does not split "
                             f"over {axes} ({n} ranks)")
        size = out.shape[d] // n
        out = out.narrow(d, mesh.axis_index(axes) * size, size)
    return out


def gather_full(block: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The inverse of :func:`local_block`: the full tensor on every rank,
    by an all-gather over each sharded dim's axes."""
    out = block
    for d, entry in enumerate(spec):
        axes = spec_axes(entry)
        if axis_size(mesh, axes or None) > 1:
            out = mesh.all_gather(out, axes, dim=d)
    return out
