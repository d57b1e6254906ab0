"""The port's examples, run as a user runs them, on the CPU at a small
size: ``examples/torch_quickstart.py`` (FMM against the direct sum),
``examples/torch_vortex_sim.py`` (the stepper's orbit invariant, a
checkpoint written and resumed, the debug-NaN lane, two ranks, and the
refusal of rank options that do not fit) and
``examples/torch_laplace_probe.py`` (Laplace at a probe grid on four ranks,
against the direct sum), ``examples/torch_fmm_serve_demo.py`` (the
four-tenant serving drill on four ranks, at the reference drill's
arguments), ``examples/torch_partition_demo.py`` (the paper's Fig 5
partition map, the reference demo's output line for line), the serving
CLI on two ranks, ``examples/torch_serve_lm.py`` (greedy decoding of a
smoke model of each LM family), ``examples/torch_train_lm.py`` and the
training launcher (a few steps, a checkpoint resumed)."""
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


@pytest.mark.parametrize("args", [("--ranks", "3", "--plan-grid", "2x2"),
                                  ("--plan-grid", "2by2")])
def test_torch_vortex_sim_refuses_the_sharded_options(args):
    """Rank options that do not fit: a grid of 4 tiles for 3 ranks, and a
    grid that is not PrxPc."""
    r = _run("torch_vortex_sim.py", *args, "--device", "cpu", timeout=120)
    assert r.returncode != 0
    assert "--plan-grid" in r.stderr and ("needs 4 ranks" in r.stderr
                                          or "must look like" in r.stderr)


def test_torch_vortex_sim_on_two_ranks_on_cpu():
    r = _run("torch_vortex_sim.py", "--n-side", "24", "--steps", "2", "--p", "8",
             "--ranks", "2", "--plan", "dynamic", "--replan-every", "1",
             "--device", "cpu")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "plan=dynamic devices=2 device=cpu" in r.stdout
    assert "step   2: max |r - r0|" in r.stdout and r.stdout.rstrip().endswith("OK")


def test_torch_laplace_probe_on_four_ranks_on_cpu():
    r = _run("torch_laplace_probe.py", "--n-charges", "2000", "--probe-side", "24",
             "--ranks", "4", "--device", "cpu")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "plan=model ranks=4 device=cpu" in r.stdout
    assert "vs direct sum: potential rel err" in r.stdout
    assert r.stdout.rstrip().endswith("OK")


def test_torch_fmm_serve_demo_on_four_ranks_on_cpu():
    r = _run("torch_fmm_serve_demo.py", "--ranks", "4", "--device", "cpu", "--n", "220",
             "--steps", "2", "--p", "6")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "== fmm_serve_demo: 4 rank(s) on cpu" in r.stdout
    assert "oversized job rejected as priced" in r.stdout
    assert "steady-state retraces: 0" in r.stdout
    assert r.stdout.count("vs f64 direct sum") == 6
    assert r.stdout.count("vs serial reference") == 2
    assert r.stdout.rstrip().endswith("== fmm_serve_demo: OK")


@pytest.mark.parametrize("distribution", ["uniform", "two-cluster"])
def test_torch_partition_demo_prints_the_reference_map(distribution):
    r = _run("torch_partition_demo.py", "--distribution", distribution, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    ref = subprocess.run([sys.executable, str(ROOT / "examples" / "partition_demo.py"),
                          "--distribution", distribution], capture_output=True, text=True,
                         timeout=300, cwd=str(ROOT),
                         env=dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu"))
    assert ref.returncode == 0, ref.stderr
    assert r.stdout == ref.stdout
    assert "== model: LB=" in r.stdout


def test_fmm_serve_cli_on_two_ranks_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.fmm_serve", "--ranks", "2",
                        "--device", "cpu", "--jobs", "4", "--n", "150", "--steps", "1",
                        "--p", "6"], capture_output=True, text=True, timeout=300, env=env,
                       cwd=str(ROOT))
    assert r.returncode == 0, r.stdout + r.stderr
    assert "== fmm_serve: 2 rank(s) on cpu" in r.stdout
    assert "jit_entries=" in r.stdout
    assert r.stdout.rstrip().endswith("== fmm_serve: OK")


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "recurrentgemma-2b",
                                  "mamba2-1.3b", "musicgen-large", "internvl2-26b"])
def test_torch_serve_lm_on_cpu(arch):
    """The port of ``examples/serve_lm.py``, one arch of each family beyond
    dense, at its smoke config."""
    r = _run("torch_serve_lm.py", "--arch", arch, "--batch", "2", "--new", "4",
             "--device", "cpu", timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "generated (first seq):" in r.stdout and "device=cpu" in r.stdout
    assert r.stdout.rstrip().endswith("OK")


@pytest.mark.parametrize("model", [("--preset", "tiny"), ("--arch", "recurrentgemma-2b")])
def test_torch_train_lm_on_cpu(tmp_path, model):
    """The port of ``examples/train_lm.py``: a preset, and a registry arch at
    its smoke config."""
    r = _run("torch_train_lm.py", *model, "--steps", "3", "--batch", "2", "--seq-len", "32",
             "--ckpt-dir", str(tmp_path), "--device", "cpu", timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "step    0  loss" in r.stdout and "step    2  loss" in r.stdout
    assert "tokens/s (steady state, cpu)" in r.stdout and r.stdout.rstrip().endswith("OK")


def test_train_launcher_local_on_cpu_resumes(tmp_path):
    """``launch/train.py --local``: an MoE smoke model with expert-load
    probes, checkpointed every 2 steps, then relaunched to resume."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    argv = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
            "granite-moe-1b-a400m", "--local", "--device", "cpu", "--ckpt-every", "2",
            "--rebalance-every", "2", "--ckpt-dir", str(tmp_path)]
    r = subprocess.run(argv + ["--steps", "2"], capture_output=True, text=True,
                       timeout=300, env=env, cwd=str(ROOT))
    assert r.returncode == 0, r.stdout + r.stderr
    assert "[train] done: 2 steps on cpu, final loss" in r.stdout
    assert (tmp_path / "step_2" / "params.npz").exists()
    r = subprocess.run(argv + ["--steps", "3"], capture_output=True, text=True,
                       timeout=300, env=env, cwd=str(ROOT))
    assert r.returncode == 0, r.stdout + r.stderr
    assert "[train] resumed at step 2" in r.stdout
    assert "[train] done: 1 steps on cpu" in r.stdout      # step 2 only
