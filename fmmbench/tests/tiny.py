"""Small copies of the benchmark's cells for tests on the CPU.

Each keeps its cell's entry, equation, order p, traffic and limits, and
only shrinks the lattice: 28 x 28 points at spacing 0.02 over a level-5
tree (up to 4 points a leaf box, 8 slots), and for probes a 64 x 64 grid.
"""
from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for path in (ROOT, ROOT / "src"):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))

import torch  # noqa: E402

from fmmbench import manifest, run  # noqa: E402

SMALL = dict(n_side=28, num_particles=784, level=5)
SIGMA = 0.025                       # lattice spacing 0.02 at ratio 0.8
CELLS = ("vortex_rk2", "vortex_probe_eval", "laplace_matvec")

# The harness's Laplace path (potential and field, singular, real charges
# drawn each evaluation), which no cell of BENCHMARK.json runs yet: a cell
# built here on the vortex configuration's lattice, for the tests alone.
LAPLACE = {
    "config": {"name": "laplace_small", "equation": "laplace", "p": 16, "sigma": None,
               "lattice_sigma": 0.02},
    "traffic": {"name": "matvec_charges", "entry": "evaluate",
                "lattice": {"centre_jitter_boxes": 1.0, "point_jitter": 0.1},
                "strengths": {"kind": "uniform", "low": -1.0, "high": 1.0,
                              "times_base": False},
                "warmup_evaluations": 3, "trace": {"start": 16, "steps": 32}},
    "limits": {"potential_rel_l2": 3e-05, "field_rel_l2": 3e-05, "start_off": 0},
}


def _laplace(root: Path) -> manifest.Cell:
    c = manifest.load_cell("vortex_probe_eval", root)
    return dataclasses.replace(c, name="laplace_matvec",
                               config=dict(c.config, **LAPLACE["config"]),
                               traffic=LAPLACE["traffic"],
                               spec={"name": "laplace_matvec", "limits": LAPLACE["limits"]})


def cell(name: str, root: Path = ROOT) -> manifest.Cell:
    c = _laplace(root) if name == "laplace_matvec" else manifest.load_cell(name, root)
    config = dict(c.config, **SMALL)
    config["lattice_sigma" if config.get("sigma") is None else "sigma"] = SIGMA
    traffic = dict(c.traffic)
    if "probes" in traffic:
        traffic["probes"] = dict(traffic["probes"], side=64)
    return dataclasses.replace(c, config=config, traffic=traffic)


def run_small(name: str, seed: int = 5, seconds: float = 0.5, control: bool = False,
              root: Path = ROOT) -> dict:
    """One run of the small cell on the CPU; adds ``correct``."""
    res = run.run_cell(cell(name, root), seed, seconds, False, torch.device("cpu"),
                       control=control)
    res["correct"] = run.passed(res["checks"]) and res["window"]["failed"] == 0
    if control:
        res["control_correct"] = run.passed(res["control_checks"])
    return res
