"""The command's refusals: no card, no program, a measurement without a card."""
from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest
import torch

from fmmbench import profiling, run
from fmmbench.tests import tiny


def command(cwd, *extra):
    return subprocess.run([sys.executable, "-m", "fmmbench.run", "--workload", "vortex_rk2",
                           "--seed", "3000000001", "--seconds", "1", "--trace", "0", *extra],
                          cwd=cwd, capture_output=True, text=True, timeout=600)


def test_without_a_card_the_command_exits_non_zero_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: this checks the refusal without one")
    out = command(tiny.ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_a_directory_with_only_the_benchmark_has_no_program(tmp_path):
    shutil.copy(tiny.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(tiny.ROOT / "fmmbench", tmp_path / "fmmbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    with pytest.raises(SystemExit):
        run.program(tmp_path)
    out = command(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_a_measurement_path_without_a_card_fails_instead_of_falling_back():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: this checks the refusal without one")
    with pytest.raises(RuntimeError):
        profiling.Spans()
    with pytest.raises(RuntimeError):
        profiling.Profile()
    with pytest.raises(RuntimeError):
        run.run_cell(tiny.cell("vortex_rk2"), 1, 0.1, True, torch.device("cpu"))


def test_end_to_end_metrics_are_taken_over_the_whole_window():
    win = {"step_s": [0.1] * 19 + [1.0], "window_s": 2.95}
    assert run.end_to_end("step_ms", win, 3.0) == pytest.approx(147.5)
    assert run.end_to_end("step_p95_ms", win, 3.0) == pytest.approx(145.0)
    assert run.end_to_end("setup_s", win, 3.0) == 3.0
    with pytest.raises(KeyError):
        run.end_to_end("tokens_per_s", win, 3.0)


PLANTED = """
import json, sys
sys.path.insert(0, {stub!r})
sys.path.insert(0, {root!r})
from fmmbench import manifest, run
cell = manifest.load_cell("vortex_probe_eval")
res = {{"window": {{"step_s": [0.1, 0.1], "window_s": 0.2, "attempted": 2, "failed": 0}},
       "trace": {{"spans": {{}}}}, "setup_s": 1.0, "checks": {{}}}}
line = run.result_line(cell, res, True, {{"platform": "gpu"}})
print(json.dumps(line))
"""


@pytest.mark.parametrize("name", sorted(run.FORBIDDEN) + [None])
def test_a_metric_reader_that_loads_a_forbidden_module_leaves_no_result(tmp_path, name):
    """The look for forbidden modules comes after every reader has run, so
    a metric file that a later change adds cannot load one unseen."""
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copy(tiny.ROOT / "BENCHMARK.json", root)
    shutil.copytree(tiny.ROOT / "fmmbench", root / "fmmbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    stub = tmp_path / "stub"
    for mod in run.FORBIDDEN:                # empty stand-ins, found first
        (stub / mod).mkdir(parents=True)
        (stub / mod / "__init__.py").write_text("")
    body = f"import {name}\n" if name else ""
    (root / "fmmbench" / "metrics" / "planted.py").write_text(
        body + "def read(trace):\n    return 1.0\n")
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["per_layer"].append({"name": "planted", "unit": "ms", "better": "lower",
                             "source": "program_span", "layer": "Step", "moves": "step_ms",
                             "workloads": ["vortex_probe_eval"]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    out = subprocess.run([sys.executable, "-c", PLANTED.format(stub=str(stub), root=str(root))],
                         cwd=root, capture_output=True, text=True, timeout=600, check=True)
    line = json.loads(out.stdout.strip().splitlines()[-1])
    if name is None:
        assert line["metrics"]["planted"]["value"] == 1.0
    else:
        assert line is None
        assert name in out.stderr
