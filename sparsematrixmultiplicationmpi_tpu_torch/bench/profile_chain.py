"""Where the chained iterate's time goes, by ``torch.profiler``.

    python -m sparsematrixmultiplicationmpi_tpu_torch.bench.profile_chain \
        [--pairs-per-step 2] [--phase-layout] [--dtype bfloat16] \
        [--spill-dma-gather] [--k K]

Builds the cop20k_A stand-in on the first CUDA device through ``Auto``
(the options go to its format search, or, for ``--spill-dma-gather``,
force the spill through kernel B7, which the H100 cost table already
takes by default), encodes a k = 32 fat vector once
(``--k`` another width: one not a multiple of 8, such as 1, is
zero-padded to the next multiple of 8 and runs the kernels),
then runs 50 back-to-back chain bodies three times: on the host clock
alone (milliseconds per body, gaps between launches included), on the
host clock without waiting for the device (the host's own issue time
per body), and under
``torch.profiler`` (each kernel's device time, and the share of the
profiled window in which the device was busy; the ``aten::`` and CUDA
runtime rows repeat their kernels' time and are left out of the sum).
Prints the profiler's
table, then one JSON line. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from ..formats.matrix import to_tensor
from ..io.generate import cop20k_like, generate_fat_vector
from ..ops import ell
from ..parallel.strategies import Auto


N = 50


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs-per-step", type=int, default=None)
    ap.add_argument("--phase-layout", action="store_true")
    ap.add_argument("--dtype", choices=("float32", "bfloat16"),
                    default="float32")
    ap.add_argument("--spill-dma-gather", action="store_true")
    ap.add_argument("--k", type=int, default=32)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_chain: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    dtype = getattr(torch, args.dtype)
    csr = cop20k_like(dtype=np.float32).astype(dtype)
    format_kwargs = {"phase_layout": args.phase_layout}
    if args.pairs_per_step is not None:
        format_kwargs["pairs_per_step"] = args.pairs_per_step
    ell.SPILL_DMA_GATHER = args.spill_dma_gather
    strategy = Auto(**format_kwargs)
    op = strategy.prepare(csr, dev)
    enc, body, _ = strategy.chain_parts(op)
    v = to_tensor(generate_fat_vector(csr.shape[1], args.k).astype(
        np.float32), dev).to(dtype)
    state = enc(v, op)

    def run():
        for _ in range(N):
            body(state, op)
        torch.cuda.synchronize(dev)

    run()  # warm-up: build, first launches
    t0 = time.perf_counter()
    run()
    host_ms = (time.perf_counter() - t0) / N * 1e3
    # The host's own time per body: N bodies enqueued with no wait (the
    # launch queue holds them), the device then drained outside the clock.
    t0 = time.perf_counter()
    for _ in range(N):
        body(state, op)
    enqueue_ms = (time.perf_counter() - t0) / N * 1e3
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall_ms = (time.perf_counter() - t0) * 1e3
    averages = prof.key_averages()
    print(averages.table(sort_by="self_device_time_total", row_limit=8))
    kernels = {e.key: {"count": e.count,
                       "us_per_launch": e.self_device_time_total / e.count}
               for e in averages if e.self_device_time_total > 0
               and not e.key.startswith(("aten::", "cuda"))}
    busy_ms = sum(k["count"] * k["us_per_launch"]
                  for k in kernels.values()) / 1e3
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    print(json.dumps({
        "device": smi.stdout.strip() or torch.cuda.get_device_name(dev),
        "format": {**format_kwargs, "dtype": args.dtype,
                   "spill_dma_gather": args.spill_dma_gather},
        "n": N, "k": args.k,
        "host_ms_per_body": host_ms, "host_enqueue_ms_per_body": enqueue_ms,
        "profiled_wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "busy_share": busy_ms / wall_ms, "kernels": kernels}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
