"""Where kernel B1's time goes on the cop20k main path, by changing its
input instead of its code.

    python -m sparsematrixmultiplicationmpi_tpu_torch.bench.probe_b1

Builds the cop20k_A stand-in on the first CUDA device through ``Auto``
(R = C = 128, U = 16, the compact tile plane on the card), then times
B1's device time per launch (fused, k = 32 unless stated; the sum of
the kernels' device time under ``torch.profiler`` over 50 launches after
warm-up, so the host's time to issue a launch does not count) on:

* the operand itself, and ``torch.sparse.mm`` on a CSR of its entries;
* the same pairs with one entry per tile (the per-pair staging and
  pipeline alone), and with every other output column emptied (half the
  entries);
* k = 8 and 16 (a quarter and half of each warp's lanes at work);
* the first N output blocks only, N from 1 to all 947 (one CTA each:
  how the time grows with the CTAs in flight per SM);
* every block given the same number of consecutive pairs (the length of
  a CTA's chain of pairs).

Prints one line per case, then one JSON line with the card's name and
power limit. Needs a CUDA device.
"""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from ..formats.windowed import CompactTiles
from ..io.generate import cop20k_like, generate_fat_vector
from ..ops import cuda_windowed as cw
from ..ops.auto import auto_format

K = 32


def device_ms(fn, n: int = 50) -> float:
    """Mean device milliseconds of the kernels ``fn()`` launches, over
    ``n`` calls after warm-up (the ``aten::`` and CUDA runtime rows,
    which repeat their kernels' time, left out)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if not e.key.startswith(("aten::", "cuda")))
    return us / n / 1e3


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("probe_b1: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    csr = cop20k_like(dtype=np.float32)
    host = auto_format(csr)
    wp = host.to(dev)
    v = torch.from_numpy(generate_fat_vector(csr.shape[1], K).astype(
        np.float32)).to(dev)
    v_p = wp.encode(v).contiguous()
    slabs = cw.chunk_slabs(v_p, C=wp.chunk_cols, split=True)
    res = {}

    def b1(ct, sl, pb=wp.pair_block, pc=wp.pair_chunk, bp=wp.block_ptr,
           nb=wp.n_blocks):
        fuse = sl.shape[1] % 16 == 0
        return device_ms(lambda: cw.windowed_matmul_tmulti(
            pb, pc, bp, ct, sl, nb=nb, pairs_per_step=1, fuse_resplit=fuse))

    def record(name, ms):
        res[name] = ms
        print(f"{name}: {ms} ms", flush=True)

    record("operand", b1(wp.tiles_t, slabs))
    dense = wp.tiles_t.to_dense()
    p, c, r = torch.nonzero(dense[:, :wp.chunk_cols] != 0, as_tuple=True)
    del dense
    a_csr = torch.sparse_coo_tensor(
        torch.stack([wp.pair_block.long()[p] * wp.block_rows + r,
                     wp.pair_chunk.long()[p] * wp.chunk_cols + c]),
        torch.ones(p.numel(), device=dev),
        (wp.n_blocks * wp.block_rows, wp.pad_rows)).coalesce().to_sparse_csr()
    record("library torch.sparse.mm", device_ms(lambda: torch.sparse.mm(
        a_csr, v_p)))
    del a_csr, p, c, r
    one = np.zeros_like(host.tiles_t)
    one[:, 0, 0] = 0x3F80  # bf16 1.0
    record("one entry per tile",
           b1(CompactTiles.from_dense(one, True).to(dev), slabs))
    del one
    half = host.tiles_t.copy()
    half[:, :, 1::2] = 0
    record("every other column emptied",
           b1(CompactTiles.from_dense(half, True).to(dev), slabs))
    del half
    for k in (8, 16):
        record(f"k = {k}", b1(wp.tiles_t, cw.chunk_slabs(
            v_p[:, :k].contiguous(), C=wp.chunk_cols, split=True)))
    for nb in (1, 132, 264, 396, 528, 947):
        record(f"first {nb} blocks", b1(wp.tiles_t, slabs,
                                        bp=wp.block_ptr[:nb + 1], nb=nb))
    for per in (1, 4, 11, 22):
        nb = min(wp.n_blocks, wp.n_pairs // per)
        bp = torch.arange(0, (nb + 1) * per, per, dtype=torch.int32,
                          device=dev)
        record(f"{nb} blocks of {per} pairs", b1(wp.tiles_t, slabs, bp=bp,
                                                 nb=nb))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    print(json.dumps({"device": smi.stdout.strip(), "k": K, "ms": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
