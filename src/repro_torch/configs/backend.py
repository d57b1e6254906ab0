"""Device choice and numeric settings for the port.

Every entry point (``build_tree``, ``fmm_velocity``, ``rk2_step``,
``init_params``, ``ServeEngine``) runs on the CUDA card unless the caller
asks for ``device="cpu"``; without a card and without that request it
raises instead of dropping to the CPU.

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
