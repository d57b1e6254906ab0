"""Architecture registry: --arch <id> -> config (full and smoke-reduced).

Lists only what the port runs: the dense LMs whose configs it carries and
the paper's vortex application.  Any other architecture of the reference's
registry raises, naming the family it belongs to.
"""
from __future__ import annotations

import importlib

ARCHS = [
    "codeqwen15_7b",
    "yi_6b",
    "petfmm_vortex",            # the paper's own client application
]

# The reference's other architectures and their families.
NOT_PORTED = {
    "qwen3_moe_235b_a22b": "moe",
    "granite_moe_1b_a400m": "moe",
    "command_r_35b": "dense",
    "qwen15_32b": "dense",
    "recurrentgemma_2b": "hybrid",
    "musicgen_large": "audio",
    "internvl2_26b": "vlm",
    "mamba2_13b": "ssm",
}

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
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"arch {arch!r} (family {NOT_PORTED[name]}) is not ported yet; "
            f"the port has {', '.join(ARCHS)}")
    if name not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}")
    return importlib.import_module(f"{__package__}.{name}")


def get_config(arch: str):
    return _module(arch).CONFIG


def get_smoke_config(arch: str):
    return _module(arch).SMOKE_CONFIG


def lm_archs() -> list[str]:
    return [a for a in ARCHS if a != "petfmm_vortex"]
