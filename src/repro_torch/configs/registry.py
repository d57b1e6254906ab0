"""Architecture registry: --arch <id> -> config (full and smoke-reduced).

The reference's registry whole: every LM architecture it lists and the
paper's vortex application.  Each config module is a data-only copy of the
reference's.
"""
from __future__ import annotations

import importlib

ARCHS = [
    "qwen3_moe_235b_a22b",
    "granite_moe_1b_a400m",
    "command_r_35b",
    "codeqwen15_7b",
    "yi_6b",
    "qwen15_32b",
    "recurrentgemma_2b",
    "musicgen_large",
    "internvl2_26b",
    "mamba2_13b",
    "petfmm_vortex",            # the paper's own client application
]

_ALIASES = {
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "command-r-35b": "command_r_35b",
    "codeqwen1.5-7b": "codeqwen15_7b",
    "yi-6b": "yi_6b",
    "qwen1.5-32b": "qwen15_32b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "musicgen-large": "musicgen_large",
    "internvl2-26b": "internvl2_26b",
    "mamba2-1.3b": "mamba2_13b",
    "petfmm-vortex": "petfmm_vortex",
}


def canonical(arch: str) -> str:
    return _ALIASES.get(arch, arch.replace("-", "_").replace(".", ""))


def _module(arch: str):
    name = canonical(arch)
    if name not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; the registry has {', '.join(ARCHS)}")
    return importlib.import_module(f"{__package__}.{name}")


def get_config(arch: str):
    return _module(arch).CONFIG


def get_smoke_config(arch: str):
    return _module(arch).SMOKE_CONFIG


def lm_archs() -> list[str]:
    return [a for a in ARCHS if a != "petfmm_vortex"]
