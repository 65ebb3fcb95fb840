"""Every parallel strategy of the PyTorch + CUDA port, validated and timed
(counterpart of ``02_distributed_strategies.py``).

Run: python examples/torch_02_distributed_strategies.py [--ranks P]
         [--device cpu]

``--ranks P`` spawns P ranks in one process group (NCCL on P cards,
gloo with ``--device cpu``); each strategy runs on the group's mesh.
"""

import argparse
import os
import sys

sys.path.insert(
    0, os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
)

import numpy as np
import torch

from sparsematrixmultiplicationmpi_tpu_torch.bench.harness import (
    device_kind, run_benchmark,
)
from sparsematrixmultiplicationmpi_tpu_torch.io.generate import cop20k_like
from sparsematrixmultiplicationmpi_tpu_torch.parallel import (
    get_strategy, run_ranks,
)

STRATEGIES = ["row", "column", "nnz", "banded_row", "auto", "library"]


def run_all(mesh):
    """Every strategy on this rank's mesh; rank 0's records print."""
    csr = cop20k_like(scale=0.02).astype(np.float32)
    recs = [run_benchmark(csr, 16, get_strategy(name), mesh,
                          matrix_name="cop20k_small", warmup=1, iters=3)
            for name in STRATEGIES]
    return [(r.strategy, r.execution_time, r.gflops, r.correct)
            for r in recs]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--ranks", type=int, default=1)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device: pass --device cpu", file=sys.stderr)
        return 1
    kind = device_kind(torch.device(args.device))
    print(f"mesh: {args.ranks} x {kind}")
    if args.ranks == 1:
        rows = run_all(torch.device(args.device))
    else:
        rows = run_ranks(run_all, args.ranks, device=args.device)[0]
    for name, t, gflops, correct in rows:
        flag = "ok" if correct else "MISMATCH"
        print(f"{name:18s} {t * 1e3:8.3f} ms  {gflops:7.2f} GFLOP/s  {flag}")
    return 0 if all(r[3] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
