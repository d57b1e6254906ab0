"""The port's two examples, run as a user runs them, on the CPU at a small
size: ``examples/torch_quickstart.py`` (FMM against the direct sum) and
``examples/torch_vortex_sim.py`` (the stepper's orbit invariant, a
checkpoint written and resumed, the debug-NaN lane, and the refusal of the
sharded options)."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _run(script, *args, timeout=600):
    # one intra-op thread: the suite's parallel workers share the cores
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, str(ROOT / "examples" / script),
                           *args], capture_output=True, text=True,
                          timeout=timeout, env=env, cwd=str(ROOT))


def test_torch_quickstart_on_cpu():
    r = _run("torch_quickstart.py", "--n-side", "30", "--p", "12",
             "--device", "cpu")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "relative L2 error vs direct sum" in r.stdout
    assert r.stdout.rstrip().endswith("OK")


def test_torch_vortex_sim_checkpoints_and_resumes_on_cpu(tmp_path):
    ck = str(tmp_path / "ck")
    r = _run("torch_vortex_sim.py", "--n-side", "20", "--steps", "2",
             "--p", "8", "--plan", "dynamic", "--replan-every", "1",
             "--checkpoint-dir", ck, "--checkpoint-every", "2",
             "--device", "cpu")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "plan=dynamic devices=1 device=cpu" in r.stdout
    assert "step   2: max |r - r0|" in r.stdout and r.stdout.rstrip().endswith("OK")
    r = _run("torch_vortex_sim.py", "--steps", "1", "--checkpoint-dir", ck,
             "--resume", "--debug-nans", "--device", "cpu")
    assert r.returncode == 0, r.stdout + r.stderr
    assert f"resumed from step 2 in {ck}" in r.stdout
    assert "step   3: max |r - r0|" in r.stdout


@pytest.mark.parametrize("args", [("--devices", "4"), ("--plan-grid", "2x2")])
def test_torch_vortex_sim_refuses_the_sharded_options(args):
    r = _run("torch_vortex_sim.py", *args, "--device", "cpu", timeout=120)
    assert r.returncode != 0
    assert "sharded driver" in r.stderr and "not ported" in r.stderr
