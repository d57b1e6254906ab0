"""What the tools that time this checkout against another share: the card's
line, another checkout's package, and the order of the turns.

A tool imports this module as ``turns``: run as ``python3 tools/<name>.py``
it has this directory on the path, and a tool that tests load from its
file puts the directory there itself.
"""
from __future__ import annotations

import importlib
import importlib.util
import subprocess
import sys
from pathlib import Path


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip()


def load_checkout(root: Path, alias: str, *modules: str) -> tuple:
    """``modules`` of another checkout's ``repro_torch`` package, imported
    as ``alias`` (its kernels build under that checkout's ``build/``)."""
    init = Path(root).resolve() / "src" / "repro_torch" / "__init__.py"
    spec = importlib.util.spec_from_file_location(
        alias, init, submodule_search_locations=[str(init.parent)])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[alias] = pkg
    spec.loader.exec_module(pkg)
    return tuple(importlib.import_module(f"{alias}.{m}") for m in modules)


def order(others: list, this) -> list:
    """The turns: the others, this checkout twice, the others in reverse,
    so that a drift of the card's clocks falls on both sides alike."""
    return [*others, this, this, *others[::-1]]
