"""Device choice and numeric settings for the port: the counterpart of
``src/repro/configs/backend.py``.

Every entry point (``build_tree``, ``fmm_velocity``, ``rk2_step``,
``init_params``, ``ServeEngine``) runs on the CUDA card unless the caller
asks for ``device="cpu"``; without a card and without that request it
raises instead of dropping to the CPU.

The reference's knobs, and what each became here:

* ``set_platform(platform)`` is not carried over: every entry point takes
  ``device=`` and :func:`resolve_device` gives the card for ``None``, so a
  process-wide default would only let a caller land on the CPU unasked.
  The XLA GPU flags the reference appends tune XLA's scheduler and have no
  torch counterpart.
* ``set_cpu_cores(n)``: intra-op threads (``torch.set_num_threads``), not
  host devices: a rank of the port is a process (``launch/mesh.py``).
* ``jax_enable_x64(flag)`` is not carried over: torch's own
  ``torch.set_default_dtype`` is that knob, and the port's kernels and
  stages name their dtypes (complex64, float32) instead of following it.

``set_debug_nan(True)`` makes ``fmm_evaluate`` and ``rk2_step`` check each
stage's output and raise at the first stage that made a non-finite value
(the brute-force lane beside the health word, which recovers instead).

TF32 stays off for matrix products and convolutions: the M2L contraction
at p=17 is held to 1e-5 relative, and TF32 keeps only a 10-bit mantissa.
bf16 products reduce in f32, as the reference's do
(``preferred_element_type``): cuBLAS's split-K may otherwise round partial
sums to bf16.
"""
from __future__ import annotations

import os
import warnings

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def resolve_device(device=None) -> torch.device:
    """``None`` -> the CUDA card; raises if CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev


def check_on(device: torch.device, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor lies on ``device`` (index-insensitive for
    the bare ``cuda`` request)."""
    for t in tensors:
        if t.device.type != device.type or (
                device.index is not None and t.device.index != device.index):
            raise ValueError(f"tensor on {t.device}, expected {device}")


DEBUG_NAN = False


def set_debug_nan(flag: bool) -> None:
    """Raise ``FloatingPointError`` at the first stage of ``fmm_evaluate``
    or ``rk2_step`` whose output holds a NaN or an infinity."""
    global DEBUG_NAN
    DEBUG_NAN = bool(flag)


def check_finite(stage: str, *tensors: torch.Tensor) -> None:
    """Under ``set_debug_nan(True)``, raise unless every value of the
    tensors is finite; otherwise do nothing."""
    if not DEBUG_NAN:
        return
    for t in tensors:
        x = torch.view_as_real(t) if t.is_complex() else t
        if not bool(torch.isfinite(x).all()):
            raise FloatingPointError(
                f"stage {stage!r} made a non-finite value (set_debug_nan)")


def set_cpu_cores(n: int) -> int:
    """Run CPU work on ``n`` intra-op threads; more than the host has
    warns and takes one fewer than it has.  Returns the count set."""
    n = int(n)
    total = os.cpu_count() or 1
    if n > total:
        warnings.warn(f"only {total} CPUs available, will use "
                      f"{max(total - 1, 1)}", Warning)
        n = total - 1
    n = max(n, 1)
    torch.set_num_threads(n)
    return n
