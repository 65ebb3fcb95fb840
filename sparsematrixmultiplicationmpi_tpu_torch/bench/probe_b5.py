"""The band kernel B5 across widths on the CG band, beside another
version of its source, so that the two compare within one call.

    python -m sparsematrixmultiplicationmpi_tpu_torch.bench.probe_b5 \\
        [--parent OLD_banded_kernels.cu] [--out FILE.json]

The operand is the models benchmark's CG system
(``spd_banded_system(121,192)``) as ``BandedBlocks`` at block_rows 128
(947 x 128 x 384, no spill). At k = 1, 8, 16, 32, 64 and 128 with an f32
band and k = 8, 32 and 128 with a bf16 one, B5 (the package's library)
and, with ``--parent``, that file's ``band_launch`` (compiled alone with
the package's nvcc flags; a source without ``band_smem`` takes the
earlier entry point, without the column chunk) are each checked against
``band_matmul_plain`` (within 1e-5 * cond + 1e-6, plus one bf16 ulp for
a bf16 band) and timed with CUDA events over 100 launches after
warm-up, in two rounds of opposite order, beside the plain version,
``spmm_banded`` and ``torch.sparse.mm`` on the band's nonzeros. Each
width's bound is the larger of its bytes (band, v and the output) over
3.35 TB/s and its products over the tensor cores' peak (three TF32
products each for f32, 495 TFLOP/s; bf16 at 989). Prints one JSON line
a width, then one with the card's name and power limit. Needs a CUDA
device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

from ..bench.systems import spd_banded_system
from ..formats.banded import BandedBlocks
from ..ops import _kernel_lib
from ..ops import cuda_banded as cb
from ..ops.banded import spmm_banded

WIDTHS = (("float32", (1, 8, 16, 32, 64, 128)),
          ("bfloat16", (8, 32, 128)))
HBM_BYTES_PER_S = 3.35e12
PEAK = {"float32": 3 * 2 / 495e12, "bfloat16": 2 / 989e12}  # s a product


def parent_launcher(path: str, out_dir: str):
    """``fn(band, v, m)`` of the ``band_launch`` in the source ``path``."""
    lib_path = os.path.join(out_dir, "parent_b5.so")
    nvcc = _kernel_lib.find_nvcc()
    run = subprocess.run([nvcc, *_kernel_lib.NVCC_FLAGS, "-shared", "-o",
                          lib_path, path], capture_output=True, text=True)
    if run.returncode != 0:
        raise RuntimeError(f"nvcc failed on {path}:\n{run.stderr}")
    lib = ctypes.CDLL(lib_path)
    chunked = hasattr(lib, "band_smem")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.band_launch.argtypes = [ptr, ptr, ptr] + [i32] * (7 if chunked
                                                           else 6) + [ptr]
    lib.band_launch.restype = i32

    def launch(band, v, m):
        nb, r, _ = band.shape
        n, k = v.shape
        out = torch.empty((m, k), dtype=band.dtype, device=band.device)
        dims = [nb, r, m, n, k] + ([cb.BAND_K_CHUNK] if chunked else [])
        err = lib.band_launch(
            band.data_ptr(), v.data_ptr(), out.data_ptr(), *dims,
            0 if band.dtype == torch.float32 else 1,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"parent band_launch: cudaError {err}")
        return out

    return launch


def cuda_ms(fn, n: int = 100, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def probe(dev, parent=None) -> list:
    spd = spd_banded_system(121_192, seed=2)
    op = BandedBlocks.from_csr(spd, block_rows=128).to(dev)
    m = spd.shape[0]
    _, r, _ = op.band.shape
    bi, i, w = torch.nonzero(op.band, as_tuple=True)
    rows, cols = bi * r + i, (bi - 1) * r + w
    keep = (rows < m) & (cols >= 0) & (cols < m)
    idx = torch.stack([rows[keep], cols[keep]])
    vals = op.band[bi, i, w][keep]
    del bi, i, w, rows, cols, keep
    res = []
    for name, ks in WIDTHS:
        dtype = getattr(torch, name)
        band = op.band.to(dtype)
        op_d = BandedBlocks(band=band, spill=None, shape=op.shape,
                            block_rows=r)
        a_csr = torch.sparse_coo_tensor(idx, vals.to(dtype), (m, m)) \
            .coalesce().to_sparse_csr()
        for k in ks:
            v = torch.from_numpy(np.random.default_rng(k).uniform(
                -1, 1, (m, k)).astype(np.float32)).to(dev, dtype)
            want = cb.band_matmul_plain(band, v, m=m).float()
            cond = cb.band_matmul_plain(band.float().abs(), v.float().abs(),
                                        m=m)
            tol = 1e-5 * cond + 1e-6
            if dtype == torch.bfloat16:
                tol = tol + 2.0 ** -7 * want.abs()
            kernels = {"b5": lambda: cb.band_matmul(band, v, m=m)}
            if parent is not None:
                kernels["parent"] = lambda: parent(band, v, m)
            row = {"dtype": name, "k": k}
            for key, fn in kernels.items():
                excess = float(((fn().float() - want).abs() - tol).max())
                if excess > 0:
                    raise RuntimeError(f"{key} {name} k={k}: outside the "
                                       f"tolerance of plain by {excess}")
                row[f"{key}_excess"] = excess
            del want, cond, tol
            fns = {**kernels,
                   "plain": lambda: cb.band_matmul_plain(band, v, m=m),
                   "spmm_banded": lambda: spmm_banded(op_d, v),
                   "library": lambda: torch.sparse.mm(a_csr, v)}
            times = {key: float("inf") for key in fns}
            for order in (list(fns), list(fns)[::-1]):
                for key in order:
                    times[key] = min(times[key], cuda_ms(fns[key]))
            row.update({f"{key}_ms": t for key, t in times.items()})
            t_bytes = (band.numel() + 2 * m * k) * band.element_size() \
                / HBM_BYTES_PER_S * 1e3
            t_ops = band.numel() * k * PEAK[name] * 1e3
            row.update(bound_ms=max(t_bytes, t_ops),
                       bound_by="bytes" if t_bytes >= t_ops else "operations")
            row["b5_bound_share"] = row["bound_ms"] / row["b5_ms"]
            print(json.dumps(row), flush=True)
            res.append(row)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="another banded_kernels.cu, as is")
    ap.add_argument("--out", help="write the rows to this JSON file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_b5: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    _kernel_lib.load_library()
    scratch = os.path.dirname(_kernel_lib.BUILD_DIR)  # build/ of the checkout
    os.makedirs(scratch, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as out_dir:
        parent = (parent_launcher(args.parent, out_dir) if args.parent
                  else None)
        rows = probe(dev, parent)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    out = {"device": smi.stdout.strip(), "rows": rows}
    print(json.dumps({"device": out["device"]}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
