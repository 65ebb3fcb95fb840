"""The compact kernels' time for variants of their source, built and
timed in one process on one card, so that they compare within one call.

    python -m sparsematrixmultiplicationmpi_tpu_torch.bench.probe_b1_variants \
        [--natural] [--parent OLD_windowed_kernels.cu] [NAME ...]

Each variant is ``csrc/windowed_kernels.cu`` with the constants of
``VARIANTS`` (B1, the default) or ``NATURAL_VARIANTS`` (B3 and B4 bf16,
``--natural``) set, or with one of the source edits of ``_EDITS``
(split3's two-FMA sum as three FMAs, the empty-pair skip turned on or
off); ``--parent``
adds another version of the file as it is. The
constants: the lanes' rows of k ``kQ``, the entries a worker loads at
once (``kBatch`` for B1 and B6, ``kNaturalBatch`` for B3 / B4), the
entries staged per window ``kCap``, the CTAs per SM of the launch bounds
(``kTmultiCtas``, ``kNaturalCtas``), and the slab bytes a thread of B3 /
B4 prefetches per window (``kNaturalPrefetch``). Each is compiled alone
into its own library with the package's nvcc flags (the ``-Xptxas -v``
registers and spills of the timed kernels printed) and checked against
the plain version (within 1e-5 * cond + 1e-6) and against the package's
own library, bit for bit:

* default: B1 on the cop20k main-path operand at k8 = 8, 16 and 32
  (unfused, and fused where k8 % 16 == 0: the fused state bitwise equal
  to the split of its unfused sum) and B6 on the phased operand
  (``Auto(phase_layout=True)``) at k = 32, then timed: B1 fused at
  k = 32, B1 unfused at k8 = 8 (a k = 1 chain body's) and B6;
* ``--natural``: B3 on the cop20k ``Auto(pairs_per_step=2)`` f32 operand
  (R = C = 256) and B4 on its bf16 build (R = C = 512), each on the
  card copy's natural compact plane; a parent without the compact
  kernel runs its dense kernel (``natural_launch``) on the dense planes.

Times are CUDA events over 200 launches after warm-up, in two rounds of
opposite order. Prints one JSON line with the card's name and power
limit. Needs a CUDA device and nvcc.
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
K = 32
B1_WIDTHS = (8, 16, 32)  # the k8 at which B1 is checked

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
    "skip": {"skip": True},
}

#: The same for B3 / B4 bf16 (``--natural``).
NATURAL_VARIANTS = {
    "package": {},
    "kNaturalCtas=3": {"kNaturalCtas": 3},
    "kNaturalBatch=1": {"kNaturalBatch": 1},
    "kNaturalBatch=2": {"kNaturalBatch": 2},
    "kNaturalBatch=3": {"kNaturalBatch": 3},
    "kNaturalBatch=8": {"kNaturalBatch": 8},
    "kNaturalPrefetch=64": {"kNaturalPrefetch": 64},
    "kNaturalPrefetch=32": {"kNaturalPrefetch": 32},
    "kNaturalPrefetch=64 kNaturalBatch=4": {"kNaturalPrefetch": 64,
                                            "kNaturalBatch": 4},
    "kCap=512": {"kCap": 512},
    "kCap=512 kNaturalBatch=4": {"kCap": 512, "kNaturalBatch": 4},
    "kCap=2048": {"kCap": 2048},
    "kQ=2 kNaturalBatch=4": {"kQ": 2, "kNaturalBatch": 4},
    "fma3": {"fma3": True},
    "noskip": {"noskip": True},
}

#: Mangled-name pieces of the kernels whose ptxas lines are printed.
B1_KERNELS = {"tmulti_kernelILb1ELb1EthE": "B1 fused",
              "tmulti_phased_kernelILb1EthE": "B6"}
NATURAL_KERNELS = {"tmulti_natural_kernelILb1EihE": "B3",
                   "tmulti_natural_kernelILb0EisE": "B4 bf16"}

#: Source edits by name: split3's two-FMA sum as three FMAs (``fma3``);
#: B1 and B6 skipping the pairs without entries in a CTA's columns
#: (``skip``), B3 and B4 not skipping them (``noskip``: each takes an
#: empty window).
_EDITS = {
    "fma3": (
        "    run[j] = fmaf(__uint_as_float(s[j] << 16), ts, run[j]);\n",
        "    run[j] = fmaf(__uint_as_float(s[j] << 16), th, run[j]);\n"
        "    run[j] = fmaf(__uint_as_float(s[j] << 16), ts - th, run[j]);\n"),
    "skip": ("constexpr bool kTmultiSkip = false;",
             "constexpr bool kTmultiSkip = true;"),
    "noskip": ("constexpr bool kNaturalSkip = true;",
               "constexpr bool kNaturalSkip = false;"),
}


def variant_source(text: str, settings: dict) -> str:
    for name, value in settings.items():
        if name in _EDITS:
            old, new = _EDITS[name]
            if text.count(old) != 1:
                raise ValueError(f"the code {name} edits is not found")
            text = text.replace(old, new)
            continue
        text, n = re.subn(rf"constexpr int {name} = \d+;",
                          f"constexpr int {name} = {value};", text)
        if n != 1:
            raise ValueError(f"constant {name} not found")
    return text


def _load(path: str) -> ctypes.CDLL:
    """A variant's library with the argument types of the entry points
    it has (a parent may lack the newer ones)."""
    lib = ctypes.CDLL(path)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    argtypes = {
        "tmulti_launch": [ptr] * 6 + [i32, ptr, ptr] + [i32] * 6 + [ptr],
        "tmulti_phased_launch": [ptr, i32] + [ptr] * 6 + [i32, ptr, ptr]
        + [i32] * 5 + [ptr],
        "natural_compact_launch": [ptr] * 6 + [i32, ptr, ptr] + [i32] * 5
        + [ptr],
        "natural_launch": [ptr] * 5 + [i32] * 5 + [ptr],
    }
    for fn, types in argtypes.items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = types
            getattr(lib, fn).restype = i32
    return lib


def build(sources: dict, out_dir: str, kernels: dict) -> dict:
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
            for piece, kernel in kernels.items():
                if "Compiling entry" in line and piece in line:
                    print(name, kernel, [x.split("info    :")[-1].strip()
                                         for x in lines[j + 2:j + 4]])
        libs[name] = _load(os.path.join(out_dir, f"v{i}.so"))
    return libs


def _check(res, name, label, got, want, cond, ref) -> None:
    """Into ``res[name]``: whether ``got`` lies within 1e-5 * cond + 1e-6
    of the plain ``want``, and whether it equals the package's ``ref``
    bit for bit (``ref`` None: ``got`` is the package's)."""
    diff = (got - want).abs()
    ok = bool((diff <= 1e-5 * cond + 1e-6).all())
    same = ref is None or torch.equal(got, ref)
    print(f"{name} {label}: correct {ok}, max diff {float(diff.max())}, "
          f"bitwise equal to the package {same}", flush=True)
    r = res.setdefault(name, {"correct": True})
    r["correct"] &= ok
    r[f"{label} bitwise_equal_to_package"] = same


def _time_rounds(runs: dict, dev) -> dict:
    """name -> ms of ``runs[name]()`` in two rounds of opposite order."""
    ms = {name: [] for name in runs}
    for order in (list(runs), list(runs)[::-1]):
        for name in order:
            for _ in range(3):
                runs[name]()
            torch.cuda.synchronize(dev)
            t = time_region(runs[name], dev, 200) / 200 * 1e3
            ms[name].append(t)
            print(f"{name}: {t} ms", flush=True)
    return ms


def _launch(fn, *args):
    def run():
        err = fn(*args)
        if err:
            raise RuntimeError(f"launch failed: cudaError {err}")
    return run


def _compact_args(ct):
    return (ct.pair_nz_ptr.data_ptr(), ct.col_ptr.data_ptr(),
            ct.rows.data_ptr(), ct.vals.data_ptr(), ct.wide)


def probe_b1(libs: dict, dev) -> dict:
    """B1 (fused and unfused, k8 = 8, 16 and 32) and B6 of every variant,
    checked and timed."""
    from ..ops.cuda_windowed import _phase_table
    from ..parallel import Auto

    csr = cop20k_like(dtype=np.float32)
    v = torch.from_numpy(generate_fat_vector(csr.shape[1], K, seed=0)
                         .astype(np.float32)).to(dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    wp = auto_format(csr).to(dev)
    ct, nb, R, C = wp.tiles_t, wp.n_blocks, wp.block_rows, wp.chunk_cols
    dense = ct.to_dense()
    plain = (wp.pair_block, wp.pair_chunk)
    cases = {}
    for k in B1_WIDTHS:
        slabs = cw.chunk_slabs(wp.encode(v[:, :k].contiguous()).contiguous(),
                               C=C, split=True)
        cases[k] = (slabs, cw.windowed_matmul_tmulti_plain(
            *plain, dense, slabs, nb=nb), cw.windowed_matmul_tmulti_plain(
            *plain, dense.abs(), slabs.abs(), nb=nb))
    del dense

    def b1(lib, out, k, fuse):
        return _launch(lib.tmulti_launch, wp.block_ptr.data_ptr(),
                       wp.pair_chunk.data_ptr(), *_compact_args(ct),
                       cases[k][0].data_ptr(), out.data_ptr(), nb, C, R, k,
                       1, int(fuse), stream)

    ph = Auto(phase_layout=True).prepare(csr, dev)
    ph_slabs = cw.chunk_slabs(ph.encode(v).contiguous(), C=C, split=True)
    table = _phase_table(tuple(ph.phases), dev)
    n_part = sum(x[4] for x in ph.phases)
    ph_dense = ph.tiles_t.to_dense()
    ph_plain = (ph.pair_block_ph, ph.pair_chunk_ph)
    # The partials of B6 in phase order, from the plain version per phase.
    ph_want, ph_cond = (torch.cat([cw.windowed_matmul_tmulti_plain(
        ph_plain[0][off:off + n], ph_plain[1][off:off + n], t[off:off + n],
        s[lo:], nb=nb_ph) for off, n, lo, _, nb_ph in ph.phases])
        for t, s in ((ph_dense, ph_slabs), (ph_dense.abs(), ph_slabs.abs())))
    del ph_dense

    def b6(lib, out):
        return _launch(lib.tmulti_phased_launch, table.data_ptr(),
                       len(ph.phases), ph.block_ptr_ph.data_ptr(),
                       ph.pair_chunk_ph.data_ptr(), *_compact_args(ph.tiles_t),
                       ph_slabs.data_ptr(), out.data_ptr(), n_part, C, R, K, 1,
                       stream)

    res, ref = {}, {}
    for name, lib in libs.items():
        for k, (_, want, cond) in cases.items():
            unfused = torch.empty((nb, k, R), dtype=torch.float32, device=dev)
            b1(lib, unfused, k, False)()
            _check(res, name, f"B1 k8={k}", unfused, want, cond,
                   ref.get(f"b1 {k}"))
            if name == "package":
                ref[f"b1 {k}"] = unfused
            if k % 16:
                continue
            fused = torch.empty((nb, k, 2 * R), dtype=torch.bfloat16,
                                device=dev)
            b1(lib, fused, k, True)()
            same = torch.equal(fused.view(torch.int16),
                               cw.resplit_slabs(unfused).view(torch.int16))
            res[name]["correct"] &= same
            res[name][f"B1 fused k8={k} equals resplit(unfused)"] = same
        part = torch.empty((n_part, K, R), dtype=torch.float32, device=dev)
        b6(lib, part)()
        _check(res, name, "B6", part, ph_want, ph_cond, ref.get("b6"))
        if name == "package":
            ref["b6"] = part
    b1_out = torch.empty((nb, K, 2 * R), dtype=torch.bfloat16, device=dev)
    k1_out = torch.empty((nb, 8, R), dtype=torch.float32, device=dev)
    b6_out = torch.empty((n_part, K, R), dtype=torch.float32, device=dev)
    for kernel, runs in (
            ("ms", {n: b1(lib, b1_out, K, True) for n, lib in libs.items()}),
            ("k8=8 unfused ms", {n: b1(lib, k1_out, 8, False)
                                 for n, lib in libs.items()}),
            ("b6_ms", {n: b6(lib, b6_out) for n, lib in libs.items()})):
        for name, ms in _time_rounds(runs, dev).items():
            res[name][kernel] = ms
    return res


def probe_natural(libs: dict, dev) -> dict:
    """B3 (f32 build) and B4 bf16 (bf16 build) of every variant on the
    cop20k two-pair operands, checked and timed."""
    csr = cop20k_like(dtype=np.float32)
    v = torch.from_numpy(generate_fat_vector(csr.shape[1], K, seed=0)
                         .astype(np.float32)).to(dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    cases = {}
    for label, dtype in (("B3", torch.float32), ("B4 bf16", torch.bfloat16)):
        wp = auto_format(csr.astype(dtype), pairs_per_step=2).to(dev)
        split = label == "B3"
        ct = wp.natural_plane
        v_p = wp.encode(v.to(dtype)).contiguous()
        slabs = cw.chunk_slabs(v_p, C=wp.chunk_cols, split=split)
        plain = (cw.windowed_matmul_split3_plain if split
                 else cw.windowed_matmul_single_plain)
        dense = ct.to_dense()
        pb, pc = wp.pair_block, wp.pair_chunk
        cases[label] = dict(
            wp=wp, ct=ct, dense=dense, slabs=slabs, split=split,
            want=plain(pb, pc, dense, slabs, nb=wp.n_blocks),
            cond=plain(pb, pc, dense.abs(), slabs.abs(), nb=wp.n_blocks))
        print(f"{label}: route R={wp.block_rows} C={wp.chunk_cols} "
              f"P={wp.n_pairs} nb={wp.n_blocks}, compact plane {ct.nnz} "
              f"entries {ct.nbytes} B", flush=True)

    def run(lib, case, out):
        wp, ct, slabs = case["wp"], case["ct"], case["slabs"]
        args = (wp.block_ptr.data_ptr(), wp.pair_chunk.data_ptr())
        if hasattr(lib, "natural_compact_launch"):
            return _launch(lib.natural_compact_launch, *args,
                           *_compact_args(ct), slabs.data_ptr(),
                           out.data_ptr(), wp.n_blocks, wp.chunk_cols,
                           wp.block_rows, K, int(case["split"]), stream)
        # A parent before the compact kernel: its dense kernel.
        return _launch(lib.natural_launch, *args, case["dense"].data_ptr(),
                       slabs.data_ptr(), out.data_ptr(), wp.n_blocks,
                       wp.chunk_cols, wp.block_rows, K,
                       0 if case["split"] else 1, stream)

    res = {}
    for label, case in cases.items():
        wp = case["wp"]
        out = torch.empty((wp.n_blocks, wp.block_rows, K),
                          dtype=torch.float32, device=dev)
        ref = None
        for name, lib in libs.items():
            got = torch.empty_like(out)
            run(lib, case, got)()
            _check(res, name, label, got, case["want"], case["cond"], ref)
            if name == "package":
                ref = got
        for name, ms in _time_rounds(
                {n: run(lib, case, out) for n, lib in libs.items()},
                dev).items():
            res[name][f"{label} ms"] = ms
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--natural", action="store_true",
                    help="B3 and B4 bf16 instead of B1 and B6")
    ap.add_argument("--parent", help="another windowed_kernels.cu, as is")
    ap.add_argument("names", nargs="*", help="variants (default: all)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_b1_variants: no CUDA device", file=sys.stderr)
        return 2
    variants = NATURAL_VARIANTS if args.natural else VARIANTS
    with open(SRC) as f:
        text = f.read()
    sources = {name: variant_source(text, variants[name])
               for name in (args.names or variants)}
    sources = {"package": text, **sources}
    if args.parent:
        with open(args.parent) as f:
            sources["parent"] = f.read()
    dev = torch.device("cuda", 0)
    scratch = os.path.dirname(_kernel_lib.BUILD_DIR)  # build/ of the checkout
    os.makedirs(scratch, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as out_dir:
        libs = build(sources, out_dir,
                     NATURAL_KERNELS if args.natural else B1_KERNELS)
        res = (probe_natural if args.natural else probe_b1)(libs, dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    print(json.dumps({"device": smi.stdout.strip(), "variants": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
