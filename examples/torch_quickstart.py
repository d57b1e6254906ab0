"""Quickstart on the PyTorch port: the velocity of N vortex particles by the
FMM, on the CUDA card (or the CPU with ``--device cpu``).

Builds a Lamb-Oseen vortex (the paper's §7 test case), runs the full FMM
(upward sweep, M2L, L2L, evaluation) and compares against the O(N^2)
direct Biot-Savart sum and the analytical solution.  On the card P2P and
M2L run their CUDA kernels; on the CPU their plain PyTorch versions.

Run:  python examples/torch_quickstart.py [--n-side 120] [--p 17] [--device cpu]
"""
import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.configs.backend import resolve_device  # noqa: E402
from repro_torch.core.fmm import fmm_velocity  # noqa: E402
from repro_torch.core.quadtree import (build_tree, choose_level,  # noqa: E402
                                       gather_particle_values)
from repro_torch.core.vortex import (direct_sum, lamb_oseen_particles,  # noqa: E402
                                     lamb_oseen_velocity)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-side", type=int, default=120)
    ap.add_argument("--p", type=int, default=17)
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain PyTorch route; default the CUDA card")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    pos, gamma, sigma = lamb_oseen_particles(args.n_side)
    n = len(pos)
    level = choose_level(n, target_per_box=8)
    print(f"N = {n} particles, tree level {level}, p = {args.p}, "
          f"sigma = {sigma:.4f}, device {dev}")

    tree, index = build_tree(pos, gamma, level, sigma, device=dev)
    fmm_velocity(tree, args.p, device=dev)          # first call: operators to the device
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    w = fmm_velocity(tree, args.p, device=dev)
    w_at = gather_particle_values(w, index).cpu().numpy()
    t_fmm = time.perf_counter() - t0

    t0 = time.perf_counter()
    exact = direct_sum(pos[:, 0] + 1j * pos[:, 1], gamma, sigma)
    t_dir = time.perf_counter() - t0

    err = np.linalg.norm(w_at - exact) / np.linalg.norm(exact)
    print(f"FMM time    : {t_fmm:.3f} s  (second call, host clock)")
    print(f"direct time : {t_dir:.3f} s")
    print(f"relative L2 error vs direct sum: {err:.3e}")

    # against the analytical Lamb-Oseen field (nu*t from the initializer)
    u_a, v_a = lamb_oseen_velocity(pos[:, 0], pos[:, 1], 1.0, 5e-4, 4.0)
    u_f, v_f = np.real(w_at), -np.imag(w_at)
    mask = np.abs(u_a) + np.abs(v_a) > 1e-3
    err_a = (np.linalg.norm((u_f - u_a)[mask]) + np.linalg.norm((v_f - v_a)[mask])) / \
            (np.linalg.norm(u_a[mask]) + np.linalg.norm(v_a[mask]))
    print(f"relative error vs analytical Lamb-Oseen: {err_a:.3e} "
          f"(discretization-limited)")
    assert err < 1e-3, err
    print("OK")


if __name__ == "__main__":
    main()
