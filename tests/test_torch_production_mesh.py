"""The production grids (``launch/mesh.py:make_production_mesh``,
``make_flat_mesh``, ``fake_world``), the training launcher's production
path, and ``analyze_trace``'s collective bytes, on the CPU.  No jax.

* On a fake world of 256 ranks ``make_production_mesh()`` is rank ``r``'s
  ``(16, 16)`` grid on ``("data", "model")``, and on 512 ranks
  ``make_production_mesh(multi_pod=True)`` its ``(2, 16, 16)`` grid on
  ``("pod", "data", "model")``: the row-major coordinates of ``r`` (device
  ``r`` of the reference's ``Mesh(devices.reshape(dims))``), a group for
  every set of axes, whose members are the ranks that share ``r``'s other
  coordinates; ``make_flat_mesh`` is the one-axis mesh over the same ranks.
* Outside such a world both refuse, naming the ranks they need; so does
  ``launch/train.py --multi-pod`` in a process that ``torchrun`` did not
  start.  In a world of 256, the launcher's ``production_grid`` builds the
  grid.
* ``analyze_trace``'s bytes follow the reference's rule (a collective's
  result, times the group for a reduce-scatter): each kind worked out by
  hand on a fake ``(2, 2)`` world.
"""
import itertools

import pytest
import torch
import torch.distributed as dist

from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import (fake_world, make_flat_mesh, make_grid_mesh,
                                     make_production_mesh)
from repro_torch.launch.trace_analysis import OpTrace, analyze_trace

CASES = [(False, 0), (False, 37), (False, 255), (True, 0), (True, 300), (True, 511)]


def _coords(r, dims):
    out = []
    for n in reversed(dims):
        out.append(r % n)
        r //= n
    return tuple(reversed(out))


@pytest.mark.parametrize("multi_pod,rank", CASES, ids=[f"{'512' if m else '256'}-r{r}"
                                                       for m, r in CASES])
def test_production_mesh_on_a_fake_world(multi_pod, rank):
    dims = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    size = 512 if multi_pod else 256
    with fake_world(size, rank=rank):
        grid = make_production_mesh(multi_pod=multi_pod, device="cpu")
        assert grid.dims == dims and grid.axis_names == axes
        assert grid.size == size and grid.rank == rank and grid.backend == "fake"
        me = _coords(rank, dims)
        assert grid.coords == me
        for k in range(1, len(axes) + 1):
            for sub in itertools.combinations(axes, k):
                want = sorted(r for r in range(size)
                              if all(_coords(r, dims)[i] == me[i]
                                     for i, a in enumerate(axes) if a not in sub))
                members = grid.members(sub)
                assert sorted(members) == want and rank in members
                assert members[grid.axis_index(sub)] == rank
                group = grid.groups[frozenset(sub)]
                if len(want) == size:
                    assert group is dist.group.WORLD
                else:
                    assert dist.get_world_size(group) == len(want)
        flat = make_flat_mesh(grid)
        assert (flat.axis, flat.size, flat.rank) == ("data", size, rank)
        assert flat.group is dist.group.WORLD and flat.backend == "fake"
    assert not dist.is_initialized()


def test_production_mesh_refuses_other_worlds():
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="256 ranks; none is initialised"):
        make_production_mesh()
    with fake_world(8):
        with pytest.raises(ValueError, match="512 ranks; it holds 8"):
            make_production_mesh(multi_pod=True)
        with pytest.raises(ValueError, match="256 ranks; it holds 8"):
            make_production_mesh()
        with pytest.raises(RuntimeError, match="already initialised"):
            with fake_world(4):
                pass
    assert not dist.is_initialized()


def test_launcher_refuses_multi_pod_without_torchrun(monkeypatch, capsys):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(SystemExit) as e:
        launch_train.main(["--arch", "yi-6b", "--multi-pod", "--device", "cpu"])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "512 ranks" in err and "torchrun" in err


def test_launcher_builds_the_production_grid_in_a_world_of_256(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "256")
    with fake_world(256, rank=5):
        grid = launch_train.production_grid(False, "cpu")
        assert grid.dims == (16, 16) and grid.coords == (0, 5)
        with pytest.raises(ValueError, match="512 ranks; it holds 256"):
            launch_train.production_grid(True, "cpu")


def test_collective_bytes_follow_the_reference_rule():
    f32, bf16, f64 = torch.float32, torch.bfloat16, torch.float64
    with fake_world(4):
        grid = make_grid_mesh((2, 2), ("data", "model"), device="cpu")
        flat = make_flat_mesh(grid)
        with OpTrace() as tr:
            grid.all_gather(torch.ones(3, 4, dtype=f32), "model", dim=0)   # (6, 4) f32: 96
            grid.all_reduce_sum(torch.ones(5, dtype=f32), ("data", "model"))   # 20
            grid.reduce_scatter(torch.ones(4, 2, dtype=bf16), "data", dim=0)   # (2, 2) x 2: 16
            grid.all_reduce_max(torch.ones(3, dtype=f64), "model")            # 24
            flat.all_gather(torch.ones(2, dtype=f32)).wait()                  # 4 x 2 f32: 32
            flat.exchange([(1, torch.ones(2, 2, dtype=f32))],
                          [(3, (3,), f32)]).wait()                          # receives 12
            flat.all_reduce_max(1.0)                                          # one f64: 8
            flat.barrier()                                                    # nothing
    st = analyze_trace(tr)
    assert st["per_kind"] == {"all_gather": 96 + 32, "all_reduce_sum": 20,
                              "reduce_scatter": 16, "all_reduce_max": 24 + 8,
                              "exchange": 12}
    assert st["collective_bytes"] == 96 + 32 + 20 + 16 + 24 + 8 + 12
    assert st["count"] == 8
