"""Device choice and numeric settings for the port.

Every entry point (``build_tree``, ``fmm_velocity``, ``rk2_step``,
``init_params``, ``ServeEngine``) runs on the CUDA card unless the caller
asks for ``device="cpu"``; without a card and without that request it
raises instead of dropping to the CPU.

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
