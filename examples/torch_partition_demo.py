"""Paper Fig 5 reproduction with the port's planner: automatic
load-balanced partition of the FMM tree, visualized as an ASCII map of
subtree -> processor assignments.  Host-side numpy only: no device work.

Run:  python examples/torch_partition_demo.py [--nparts 16]
"""
import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core.cost_model import ModelParams  # noqa: E402
from repro_torch.core.partition import (build_subtree_graph, partition,  # noqa: E402
                                        partition_stats)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nparts", type=int, default=16)
    ap.add_argument("--level", type=int, default=8)
    ap.add_argument("--cut", type=int, default=4)
    ap.add_argument("--distribution", default="uniform",
                    choices=["uniform", "gaussian", "two-cluster"])
    args = ap.parse_args()

    rng = np.random.default_rng(0)
    n = 1 << args.level
    N = 200_000
    if args.distribution == "uniform":
        pos = rng.uniform(0, 1, (N, 2))
    elif args.distribution == "gaussian":
        pos = rng.normal(0.5, 0.15, (N, 2)).clip(0.001, 0.999)
    else:
        a = rng.normal((0.3, 0.3), 0.08, (N // 2, 2))
        b = rng.normal((0.75, 0.7), 0.12, (N // 2, 2))
        pos = np.concatenate([a, b]).clip(0.001, 0.999)
    ij = (pos * n).astype(int)
    counts = np.zeros((n, n), dtype=np.int64)
    np.add.at(counts, (ij[:, 1], ij[:, 0]), 1)

    params = ModelParams(level=args.level, cut=args.cut, p=17,
                         slots=max(int(counts.max()), 1))
    g = build_subtree_graph(counts, params)
    nsub = 1 << args.cut

    for method in ("uniform-sfc", "model"):
        assign = partition(g, args.nparts, method=method)
        stats = partition_stats(g, assign, args.nparts)
        print(f"\n== {method}: LB={stats['load_balance']:.3f} "
              f"cut={stats['edge_cut']:.2e} imbalance={stats['imbalance']:.3f}")
        grid = assign.reshape(nsub, nsub)
        sym = "0123456789abcdefghijklmnopqrstuvwxyz"
        for row in grid:
            print("  " + " ".join(sym[v % len(sym)] for v in row))
    print("\n(paper Fig 5: 256 subtrees distributed among 16 partitions)")


if __name__ == "__main__":
    main()
