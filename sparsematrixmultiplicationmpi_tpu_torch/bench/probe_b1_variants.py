"""B1's time for variants of its source, built and timed in one process
on one card, so that they compare within one call.

    python -m sparsematrixmultiplicationmpi_tpu_torch.bench.probe_b1_variants \
        [--parent OLD_windowed_kernels.cu] [NAME ...]

Each variant is ``csrc/windowed_kernels.cu`` with the constants of
``VARIANTS`` set (the lanes' rows of k ``kQ``, the entries a worker loads
at once ``kBatch``, the entries staged per window ``kCap``, the CTAs per
SM of the launch bounds ``kTmultiCtas``), or split3's two-FMA sum written
as three FMAs (``fma3``); ``--parent`` adds another version of the file
as it is. Each is compiled alone into its own library with the package's
nvcc flags (the ``-Xptxas -v`` registers and spills of the fused B1 and
of B6 printed), checked on the cop20k main-path operand against the
plain version (within 1e-5 * cond + 1e-6, the fused state bitwise equal
to the split of its unfused sum), then timed fused at k = 32 (CUDA
events over 200 launches after warm-up) in two rounds of opposite order.
Prints one JSON line with the card's name and power limit. Needs a CUDA
device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile

import numpy as np
import torch

from ..io.generate import cop20k_like, generate_fat_vector
from ..ops import _kernel_lib
from ..ops import cuda_windowed as cw
from ..ops.auto import auto_format
from ..utils.timing import time_region

SRC = os.path.join(_kernel_lib.CSRC_DIR, "windowed_kernels.cu")

#: name -> the constants it sets (the package's values elsewhere).
VARIANTS = {
    "package": {},
    "kBatch=1": {"kBatch": 1},
    "kBatch=3": {"kBatch": 3},
    "kBatch=4": {"kBatch": 4},
    "kBatch=8": {"kBatch": 8},
    "kQ=2": {"kQ": 2},
    "kQ=2 kBatch=4": {"kQ": 2, "kBatch": 4},
    "kCap=512": {"kCap": 512},
    "kCap=256": {"kCap": 256},
    "kCap=256 kTmultiCtas=4": {"kCap": 256, "kTmultiCtas": 4},
    "kCap=512 kBatch=4": {"kCap": 512, "kBatch": 4},
    "kTmultiCtas=2 kBatch=4": {"kTmultiCtas": 2, "kBatch": 4},
    "kTmultiCtas=2 kBatch=8": {"kTmultiCtas": 2, "kBatch": 8},
    "fma3": {"fma3": True},
    "fma3 kBatch=4": {"fma3": True, "kBatch": 4},
}

_FMA2 = "    run[j] = fmaf(__uint_as_float(s[j] << 16), ts, run[j]);\n"
_FMA3 = ("    run[j] = fmaf(__uint_as_float(s[j] << 16), th, run[j]);\n"
         "    run[j] = fmaf(__uint_as_float(s[j] << 16), ts - th, run[j]);\n")


def variant_source(text: str, settings: dict) -> str:
    for name, value in settings.items():
        if name == "fma3":
            if text.count(_FMA2) != 1:
                raise ValueError("split3's two-FMA sum not found")
            text = text.replace(_FMA2, _FMA3)
            continue
        text, n = re.subn(rf"constexpr int {name} = \d+;",
                          f"constexpr int {name} = {value};", text)
        if n != 1:
            raise ValueError(f"constant {name} not found")
    return text


def build(sources: dict, out_dir: str) -> dict:
    """Compile every source at once; name -> its loaded library."""
    nvcc = _kernel_lib.find_nvcc()
    procs = {}
    for i, (name, text) in enumerate(sources.items()):
        src = os.path.join(out_dir, f"v{i}.cu")
        with open(src, "w") as f:
            f.write(text)
        procs[name] = (subprocess.Popen(
            [nvcc, *_kernel_lib.NVCC_FLAGS, "-shared", "-o",
             os.path.join(out_dir, f"v{i}.so"), src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), i)
    libs = {}
    for name, (p, i) in procs.items():
        report = p.communicate()[0]
        if p.returncode:
            print(f"{name}: build failed\n{report[-3000:]}")
            continue
        lines = report.splitlines()
        for j, line in enumerate(lines):
            if "Compiling entry" in line and (
                    "tmulti_kernelILb1ELb1EthE" in line
                    or "tmulti_phased_kernelILb1EthE" in line):
                kernel = "B6" if "phased" in line else "B1 fused"
                print(name, kernel, [x.split("info    :")[-1].strip()
                                     for x in lines[j + 2:j + 4]])
        lib = ctypes.CDLL(os.path.join(out_dir, f"v{i}.so"))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.tmulti_launch.argtypes = [ptr] * 6 + [i32, ptr, ptr] + [i32] * 6 \
            + [ptr]
        lib.tmulti_launch.restype = i32
        libs[name] = lib
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="another windowed_kernels.cu, as is")
    ap.add_argument("names", nargs="*", help="variants (default: all)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_b1_variants: no CUDA device", file=sys.stderr)
        return 2
    with open(SRC) as f:
        text = f.read()
    sources = {name: variant_source(text, VARIANTS[name])
               for name in (args.names or VARIANTS)}
    if args.parent:
        with open(args.parent) as f:
            sources["parent"] = f.read()
    dev = torch.device("cuda", 0)
    scratch = os.path.dirname(_kernel_lib.BUILD_DIR)  # build/ of the checkout
    os.makedirs(scratch, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as out_dir:
        libs = build(sources, out_dir)
        csr = cop20k_like(dtype=np.float32)
        wp = auto_format(csr).to(dev)
        v = torch.from_numpy(generate_fat_vector(csr.shape[1], 32, seed=0)
                             .astype(np.float32)).to(dev)
        slabs = cw.chunk_slabs(wp.encode(v).contiguous(), C=wp.chunk_cols,
                               split=True)
        ct, nb, R = wp.tiles_t, wp.n_blocks, wp.block_rows
        dense = ct.to_dense()
        plain = (wp.pair_block, wp.pair_chunk)
        want = cw.windowed_matmul_tmulti_plain(*plain, dense, slabs, nb=nb)
        cond = cw.windowed_matmul_tmulti_plain(*plain, dense.abs(),
                                               slabs.abs(), nb=nb)
        del dense
        stream = torch.cuda.current_stream(dev).cuda_stream

        def launcher(lib, out, fuse):
            def run():
                err = lib.tmulti_launch(
                    wp.block_ptr.data_ptr(), wp.pair_chunk.data_ptr(),
                    ct.pair_nz_ptr.data_ptr(), ct.col_ptr.data_ptr(),
                    ct.rows.data_ptr(), ct.vals.data_ptr(), ct.wide,
                    slabs.data_ptr(), out.data_ptr(), nb, wp.chunk_cols, R,
                    32, 1, int(fuse), stream)
                if err:
                    raise RuntimeError(f"launch failed: cudaError {err}")
            return run

        res = {}
        for name, lib in libs.items():
            unfused = torch.empty((nb, 32, R), dtype=torch.float32,
                                  device=dev)
            fused = torch.empty((nb, 32, 2 * R), dtype=torch.bfloat16,
                                device=dev)
            launcher(lib, unfused, False)()
            launcher(lib, fused, True)()
            diff = (unfused - want).abs()
            ok = bool((diff <= 1e-5 * cond + 1e-6).all()) and torch.equal(
                fused.view(torch.int16),
                cw.resplit_slabs(unfused).view(torch.int16))
            print(f"{name}: correct {ok}, max diff {float(diff.max())}",
                  flush=True)
            res[name] = {"correct": ok, "ms": []}
        for order in (list(libs), list(libs)[::-1]):
            for name in order:
                out = torch.empty((nb, 32, 2 * R), dtype=torch.bfloat16,
                                  device=dev)
                run = launcher(libs[name], out, True)
                for _ in range(3):
                    run()
                torch.cuda.synchronize(dev)
                ms = time_region(run, dev, 200) / 200 * 1e3
                res[name]["ms"].append(ms)
                print(f"{name}: {ms} ms", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    print(json.dumps({"device": smi.stdout.strip(), "variants": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
