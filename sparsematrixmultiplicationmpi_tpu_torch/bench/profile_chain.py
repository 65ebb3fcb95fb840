"""Where the chained iterate's time goes, by ``torch.profiler``.

    python -m sparsematrixmultiplicationmpi_tpu_torch.bench.profile_chain

Builds the cop20k_A stand-in (f32) on the first CUDA device through
``Auto``, encodes a k = 32 fat vector once, then runs 50 back-to-back
chain bodies twice: on the host clock alone (milliseconds per body, gaps
between launches included) and under ``torch.profiler`` (each kernel's
device time, and the share of the profiled window in which the device
was busy). Prints the profiler's table, then one JSON line. Needs a CUDA
device.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from ..io.generate import cop20k_like, generate_fat_vector
from ..parallel.strategies import Auto


N, K = 50, 32


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_chain: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    csr = cop20k_like(dtype=np.float32)
    strategy = Auto()
    op = strategy.prepare(csr, dev)
    enc, body, _ = strategy.chain_parts(op)
    v = torch.from_numpy(generate_fat_vector(csr.shape[1], K)
                         .astype(np.float32)).to(dev)
    state = enc(v, op)

    def run():
        for _ in range(N):
            body(state, op)
        torch.cuda.synchronize(dev)

    run()  # warm-up: build, first launches
    t0 = time.perf_counter()
    run()
    host_ms = (time.perf_counter() - t0) / N * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall_ms = (time.perf_counter() - t0) * 1e3
    averages = prof.key_averages()
    print(averages.table(sort_by="self_device_time_total", row_limit=8))
    kernels = {e.key: {"count": e.count,
                       "us_per_launch": e.self_device_time_total / e.count}
               for e in averages if e.self_device_time_total > 0}
    busy_ms = sum(e.self_device_time_total for e in averages) / 1e3
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    print(json.dumps({
        "device": smi.stdout.strip() or torch.cuda.get_device_name(dev),
        "n": N, "k": K,
        "host_ms_per_body": host_ms,
        "profiled_wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "busy_share": busy_ms / wall_ms, "kernels": kernels}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
