"""Guards of the port: it imports neither jax nor the reference package, and
its entry points never drop to the CPU on their own."""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__")):
            yield node.lineno, node.args[0].value


def test_port_imports_no_jax_and_no_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for module in ("core/parallel_fmm.py", "launch/mesh.py",
                   "serve/fmm_service.py", "launch/fmm_serve.py",
                   "parallel/__init__.py", "parallel/resilience.py",
                   "launch/supervisor.py", "configs/backend.py",
                   "launch/trace_analysis.py", "analysis/__init__.py",
                   "analysis/check.py", "analysis/contracts.py",
                   "analysis/lint.py", "analysis/retrace.py",
                   "analysis/schedule.py", "models/moe.py", "models/rglru.py",
                   "models/mamba2.py", "optim/__init__.py", "optim/adamw.py",
                   "data/__init__.py", "data/pipeline.py", "train/__init__.py",
                   "train/loop.py", "launch/train.py", "parallel/sharding.py"):
        assert ROOT / "src" / "repro_torch" / module in files
    bad = [f"{f.relative_to(ROOT)}:{line}: {mod}"
           for f in files for line, mod in _imported_modules(f)
           if mod.split(".")[0] in FORBIDDEN]
    assert not bad, "\n".join(bad)


def test_port_examples_import_no_jax_and_no_reference():
    files = sorted((ROOT / "examples").glob("torch_*.py"))
    assert len(files) == 7
    for example in ("torch_fmm_serve_demo.py", "torch_partition_demo.py",
                    "torch_serve_lm.py", "torch_train_lm.py"):
        assert ROOT / "examples" / example in files
    bad = [f"{f.relative_to(ROOT)}:{line}: {mod}"
           for f in files for line, mod in _imported_modules(f)
           if mod.split(".")[0] in FORBIDDEN]
    assert not bad, "\n".join(bad)


def test_stepper_entry_points_raise_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    from repro_torch.core.stepper import VortexStepper
    rng = np.random.default_rng(0)
    pos, gamma = rng.uniform(size=(50, 2)), rng.normal(size=50)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VortexStepper(pos, gamma, 0.01)
    st = VortexStepper(pos, gamma, 0.01, p=4, device="cpu",
                       checkpoint_dir=str(tmp_path))
    st.save_checkpoint()
    st._ckpt.wait()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VortexStepper.from_checkpoint(str(tmp_path))


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    from repro_torch.core.fmm import fmm_velocity
    from repro_torch.core.quadtree import build_tree, tree_from_numpy
    from repro_torch.core.stepper import rk2_step
    rng = np.random.default_rng(0)
    pos, gamma = rng.uniform(size=(50, 2)), rng.normal(size=50)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_tree(pos, gamma, level=2, sigma=0.01)
    tree, _ = build_tree(pos, gamma, level=2, sigma=0.01, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fmm_velocity(tree, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rk2_step(tree, 1e-3, p=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tree_from_numpy(tree.z.numpy(), tree.q.numpy(), tree.mask.numpy(), 2, 0.01)


def test_sharded_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    from repro_torch.core.parallel_fmm import (parallel_fmm_evaluate,
                                               parallel_fmm_p2p_prefetch)
    from repro_torch.core.quadtree import build_tree
    from repro_torch.launch.mesh import make_grid_mesh, make_local_mesh, spawn_world
    rng = np.random.default_rng(0)
    pos, gamma = rng.uniform(size=(50, 2)), rng.normal(size=50)
    tree, _ = build_tree(pos, gamma, level=2, sigma=0.01, device="cpu")
    for call in (lambda: parallel_fmm_evaluate(tree, 8),
                 lambda: parallel_fmm_p2p_prefetch(tree),
                 lambda: make_local_mesh(),
                 lambda: make_grid_mesh((1, 1)),
                 lambda: spawn_world(print, 2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_analysis_check_raises_without_a_card():
    """``python -m repro_torch.analysis.check`` checks the card's route by
    default: without a card it raises, and ``--device cuda`` never runs the
    CPU route instead."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    from repro_torch.analysis import check
    from repro_torch.analysis.schedule import simulate
    for argv in ([], ["--device", "cuda"], ["--device", "cuda", "--skip", "lint"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            check.main(argv)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        simulate(print, 2)


def test_lm_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    from repro_torch.configs.yi_6b import SMOKE_CONFIG
    from repro_torch.launch import serve
    from repro_torch.models.transformer import init_cache, init_params
    from repro_torch.serve.engine import ServeEngine
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(SMOKE_CONFIG)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_cache(SMOKE_CONFIG, 1, 8)
    params = init_params(SMOKE_CONFIG, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(params, SMOKE_CONFIG, batch_slots=1, max_len=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "yi-6b", "--local"])


def test_training_entry_points_raise_without_a_card(tmp_path):
    """The Trainer, the data pipeline and the training launcher run on the
    card unless asked for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    from repro_torch.configs.yi_6b import SMOKE_CONFIG
    from repro_torch.data.pipeline import PipelineState, make_batch
    from repro_torch.launch import train
    from repro_torch.models.config import ShapeConfig
    from repro_torch.train.loop import Trainer, TrainerConfig
    shape = ShapeConfig("t", "train", 16, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(SMOKE_CONFIG, shape, tcfg=TrainerConfig(ckpt_dir=str(tmp_path)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_batch(PipelineState(0, 0), SMOKE_CONFIG, 2, 16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "yi-6b", "--local", "--ckpt-dir", str(tmp_path)])


def test_engine_refuses_parameters_on_another_device():
    from repro_torch.configs.yi_6b import SMOKE_CONFIG
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.engine import ServeEngine
    params = init_params(SMOKE_CONFIG, device="meta")
    with pytest.raises(ValueError, match="expected cpu"):
        ServeEngine(params, SMOKE_CONFIG, batch_slots=1, max_len=16, device="cpu")


def test_fmm_service_entry_points_raise_without_a_card():
    """The engine, the CLI and the demo run on the card unless asked for
    the CPU: without a card they raise, on one rank and on several."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    import importlib.util
    from repro_torch.launch import fmm_serve
    from repro_torch.serve import fmm_service as svc
    with pytest.raises(RuntimeError, match="no CUDA device"):
        svc.FmmServiceEngine()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        svc.ensure_device(svc.Tree(z=np.zeros((4, 4, 1)), q=np.zeros((4, 4, 1)),
                                   mask=np.zeros((4, 4, 1), bool), level=2, sigma=0.1))
    for argv in ([], ["--ranks", "2"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fmm_serve.main(argv)
    spec = importlib.util.spec_from_file_location(
        "torch_fmm_serve_demo", ROOT / "examples" / "torch_fmm_serve_demo.py")
    demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(demo)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        demo.drill(None, demo.parse(["--ranks", "1"]))
