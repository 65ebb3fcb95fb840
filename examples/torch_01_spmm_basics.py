"""Basic SpMM through the PyTorch + CUDA port: load, multiply, validate —
the reference's ``./main`` flow (counterpart of ``01_spmm_basics.py``).

Run: python examples/torch_01_spmm_basics.py [matrix.mtx] [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(
    0, os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
)

import numpy as np
import torch

import sparsematrixmultiplicationmpi_tpu_torch as smt
from sparsematrixmultiplicationmpi_tpu_torch.io.generate import cop20k_like
from sparsematrixmultiplicationmpi_tpu_torch.ops.auto import (
    auto_format, spmm_any,
)
from sparsematrixmultiplicationmpi_tpu_torch.utils.compare import (
    default_tolerance,
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("matrix", nargs="?", help=".mtx file (default: a "
                    "small cop20k stand-in)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device: pass --device cpu", file=sys.stderr)
        return 1
    if args.matrix:
        csr = smt.read_matrix_market(args.matrix)
    else:
        csr = cop20k_like(scale=0.05)  # synthetic demo matrix
    csr = csr.astype(np.float32)
    m, n = csr.shape
    print(f"matrix {m}x{n}, {csr.nnz} nnz")

    k = 32
    v_host = smt.generate_fat_vector(n, k, seed=0).astype(np.float32)
    v = torch.from_numpy(v_host).to(args.device)

    # Windowed tiles, band, or a gather format, priced for one multiply
    # on the device.
    operand = auto_format(csr, device=args.device, one_shot=True)
    print(f"format: {type(operand).__name__}")
    out = spmm_any(operand.to(args.device), v)

    oracle = smt.spmm_host_f64(csr, v_host)
    ok = smt.are_matrices_equal(
        out.cpu().double().numpy(), oracle,
        tolerance=default_tolerance(np.float32), relative=True)
    print("Results are the same!" if ok else "Results are different!")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
