"""Fault-tolerant checkpointing: atomic writes, async save, keep-last-k.

Format (the reference package's, so either package restores what the
other wrote): one ``<name>.npz`` per saved tree under ``<dir>/step_<n>.tmp``,
renamed atomically to ``step_<n>`` once complete, plus a ``LATEST`` pointer
file written last.  A tree is a nested dict, list or tuple of tensors or
arrays; its npz keys are the leaves' paths joined by ``/``, dict keys in
sorted order and sequence positions as their index, as ``jax.tree_util``
spells them.  numpy has no bf16: a bf16 tensor is written widened to f32
(exactly) and read back as f32, for the caller to round to bf16 again
(exactly).  A crash mid-save never corrupts the previous checkpoint;
restore reads ``LATEST``, falling back to the newest complete step
directory when ``LATEST`` is missing, corrupt, or dangling.

Durability: every payload file, ``meta.json`` and ``LATEST`` are fsync'd
before their rename, and the checkpoint directory is fsync'd after, so the
commit point survives power loss, not just process death.  Errors raised
inside the async writer thread are captured and re-raised on the next
``save()`` / ``wait()``: a failed snapshot is never silent.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch


def _fsync_file(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path: str) -> None:
    # directory fsync makes the rename itself durable (POSIX: metadata
    # lives in the parent directory's log)
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    except OSError:
        pass            # some filesystems refuse fsync on directories
    finally:
        os.close(fd)


def _leaves(tree, prefix=()):
    """``(path, leaf)`` pairs of a nested dict/list/tuple, in the order and
    spelling of ``jax.tree_util``'s flattening (None holds no leaf)."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def to_host(leaf) -> np.ndarray:
    """A copy of a tensor or array in host memory (bf16 widened to f32),
    never a view of it: an async save writes the copy while training
    updates the tensor in place, also when the tensor already lies on the
    CPU."""
    if isinstance(leaf, torch.Tensor):
        dt = torch.float32 if leaf.dtype == torch.bfloat16 else leaf.dtype
        return leaf.detach().to("cpu", dt, copy=True).numpy()
    return np.array(leaf)


def numpy_dtype(leaf) -> np.dtype:
    """The numpy dtype of a tensor or array as :func:`to_host` gives it,
    without copying it."""
    if isinstance(leaf, torch.Tensor):
        dt = torch.float32 if leaf.dtype == torch.bfloat16 else leaf.dtype
        return torch.empty((), dtype=dt).numpy().dtype
    return np.asarray(leaf).dtype


def _flatten(tree) -> dict[str, np.ndarray]:
    return {key: to_host(leaf) for key, leaf in _leaves(tree)}


def _unflatten_into(template, data: dict[str, np.ndarray], prefix=()):
    """Arrays of ``data`` in ``template``'s structure, shapes checked and
    cast to the template leaves' dtypes."""
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: _unflatten_into(template[k], data, prefix + (str(k),))
                for k in template}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten_into(v, data, prefix + (str(i),))
                              for i, v in enumerate(template))
    key = "/".join(prefix)
    arr = data[key]
    if tuple(arr.shape) != tuple(template.shape):
        raise ValueError(f"checkpoint shape mismatch at {key}: "
                         f"{arr.shape} vs {tuple(template.shape)}")
    return arr.astype(numpy_dtype(template))


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------

    def _raise_pending(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(
                "previous async checkpoint save failed") from err

    def save(self, step: int, trees: dict[str, Any], meta: Optional[dict] = None):
        """trees: name -> nested dict/list/tuple of tensors or arrays.
        Blocks only to copy them to host memory (a copy on the CPU too).

        An exception from a previous async save surfaces HERE (or in
        :meth:`wait`) rather than dying silently in the writer thread."""
        host = {name: _flatten(t) for name, t in trees.items()}
        meta = dict(meta or {})
        meta["step"] = step
        if self._thread is not None:
            self._thread.join()     # one in-flight save at a time
            self._thread = None
        self._raise_pending()
        if self.async_save:
            self._thread = threading.Thread(
                target=self._write_guarded, args=(step, host, meta),
                daemon=True)
            self._thread.start()
        else:
            self._write(step, host, meta)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_pending()

    def _write_guarded(self, step: int, host: dict, meta: dict):
        try:
            self._write(step, host, meta)
        except BaseException as e:      # surfaces on next save()/wait()
            self._error = e

    def _write(self, step: int, host: dict, meta: dict):
        tmp = os.path.join(self.dir, f"step_{step}.tmp")
        final = os.path.join(self.dir, f"step_{step}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        for name, data in host.items():
            path = os.path.join(tmp, f"{name}.npz")
            np.savez(path, **data)
            _fsync_file(path)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)
        _fsync_dir(self.dir)    # make the rename durable before LATEST
        # LATEST pointer written last -> atomic commit point
        with open(os.path.join(self.dir, "LATEST.tmp"), "w") as f:
            f.write(str(step))
            f.flush()
            os.fsync(f.fileno())
        os.replace(os.path.join(self.dir, "LATEST.tmp"),
                   os.path.join(self.dir, "LATEST"))
        _fsync_dir(self.dir)
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"), ignore_errors=True)

    # -- restore ------------------------------------------------------------

    def all_steps(self) -> list[int]:
        steps = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    steps.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        """Newest RESTORABLE step: LATEST's referent when it exists on
        disk, else the newest complete step directory (LATEST can dangle
        after a crash between GC and pointer update, or point at a step a
        concurrent ``keep`` policy collected)."""
        path = os.path.join(self.dir, "LATEST")
        step = None
        if os.path.exists(path):
            try:
                with open(path) as f:
                    step = int(f.read().strip())
            except (ValueError, OSError):
                step = None
        if step is not None and os.path.isdir(
                os.path.join(self.dir, f"step_{step}")):
            return step
        steps = self.all_steps()
        return steps[-1] if steps else None

    def load_meta(self, step: Optional[int] = None) -> Optional[dict]:
        """Read a checkpoint's meta.json without restoring any arrays —
        callers use it to build restore templates (shapes/dtypes) first."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        with open(os.path.join(self.dir, f"step_{step}", "meta.json")) as f:
            return json.load(f)

    def restore(self, templates: dict[str, Any], step: Optional[int] = None):
        """Restore each named tree into its template's structure, as numpy
        arrays of the template leaves' shapes and dtypes; returns
        ``(trees, meta)``, or ``(None, None)`` when there is no checkpoint."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None, None
        base = os.path.join(self.dir, f"step_{step}")
        out = {}
        for name, template in templates.items():
            with np.load(os.path.join(base, f"{name}.npz")) as z:
                data = {k: z[k] for k in z.files}
            out[name] = _unflatten_into(template, data)
        with open(os.path.join(base, "meta.json")) as f:
            meta = json.load(f)
        return out, meta
