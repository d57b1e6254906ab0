"""Find a cell's files by name, from ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names its configuration and traffic
mix; the harness reads

* ``configs``' ``file`` for the configuration,
* ``fmmbench/traffic/<traffic>.json`` for the traffic mix, which names its
  entry, ``fmmbench/entries/<entry>.py``,
* ``fmmbench/workloads/<cell>.json`` for the cell's checks and limits,
* ``fmmbench/metrics/<metric>.py`` for each per-layer metric it reports.

Modules are loaded from their files under ``root``, so a copy of the
benchmark with added files runs as it stands.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = "fmmbench"


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    spec: dict                    # fmmbench/workloads/<cell>.json
    end_to_end: tuple             # the manifest's metric entries this cell reports
    per_layer: tuple
    root: Path


def load_manifest(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    root = Path(root)
    manifest = load_manifest(root)
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((root / PACKAGE / "traffic" / f"{w['traffic']}.json").read_text())
    spec = json.loads((root / PACKAGE / "workloads" / f"{name}.json").read_text())
    return Cell(name=name, chips=int(w["chips"]), config=config, traffic=traffic,
                spec=spec,
                end_to_end=tuple(m for m in manifest["end_to_end"] if _reports(m, name)),
                per_layer=tuple(m for m in manifest["per_layer"] if _reports(m, name)),
                root=root)


def load_module(root: Path, kind: str, name: str):
    """``fmmbench/<kind>/<name>.py`` under ``root``, imported from its file."""
    path = Path(root) / PACKAGE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(f"{PACKAGE}_{kind}_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
