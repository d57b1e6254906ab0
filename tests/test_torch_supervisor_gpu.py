"""The kill drill on the card: 4 gloo ranks sharing the CUDA card, rank 2
SIGKILLed mid-step 4, the run completed at step 6 on (0, 1, 3) through the
kernels, at the CPU drills' size (``test_torch_supervisor.py``).  Decides
inside the test whether a card exists; imports no jax."""
import json
import os

import numpy as np
import pytest
import torch

from repro_torch.core.faults import FaultInjector, FaultSpec
from repro_torch.launch import supervisor as sv
from repro_torch.launch.mesh import spawn_world
from repro_torch.parallel import resilience as rz


@pytest.mark.gpu
def test_kill_drill_on_the_card_matches_a_clean_restore(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = sv.SupervisorConfig(
        world=4, target_step=6, coord_dir=str(tmp_path), n_side=20, p=4, dt=0.004,
        checkpoint_every=2, checkpoint_keep=8,
        watchdog=rz.WatchdogPolicy(compile_grace=120.0, teardown_grace=30.0,
                                   agree_timeout=60.0),
        restart=rz.RestartPolicy(min_world=2, backoff_base=0.1), max_wall=300.0)
    result = sv.Supervisor(cfg, faults=FaultInjector(
        FaultSpec(site="proc_kill", step=4, device=2))).run()
    assert result.success and result.ranks == (0, 1, 3)
    rep = result.faults[0]
    assert 2 in rep.dead and rep.detect_seconds < 120.0
    outs = []
    for r in result.ranks:
        with np.load(os.path.join(result.result_dir, f"result_{r}.npz")) as z:
            outs.append({k: z[k] for k in ("z", "q", "mask")})
        with open(os.path.join(result.result_dir, f"result_{r}.json")) as f:
            rec = json.load(f)
        assert rec["device"].startswith("cuda")
        for s in rec["steps"]:             # every step through the kernels
            assert s["recovered"] == "" and s["plain"] == 0
            assert (s["p2p"], s["m2l"]) == (s["expected"]["p2p"], s["expected"]["m2l"])
    for o in outs[1:]:
        for k in o:
            np.testing.assert_array_equal(o[k], outs[0][k])
    clean = spawn_world(sv.clean_restore, 3, device="cuda", timeout_s=120,
                        args=(cfg.checkpoint_dir, rep.restore_step, 6,
                              sv.restore_kwargs(cfg)))
    for c in clean:
        for k in ("z", "q", "mask"):
            np.testing.assert_array_equal(outs[0][k], c[k])
