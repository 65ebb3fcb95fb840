"""A closed loop of chained multiplies: ``x <- A x`` back to back, each
body's output the next body's input (SGC-style propagation ``A^K X``,
power iteration).

Set-up builds the operand through ``Auto`` (``format`` of the traffic
file goes to it), takes its ``chain_parts`` and encodes ``v0`` once; the
window runs bodies until ``--seconds`` have passed and ends in a
synchronize. Bodies ``0 .. start_steps-1``, ``samples`` more drawn from
the seed in ``sample_range`` and the window's last body keep their input
and output states (references to what the body returned, no copies);
they are decoded, with the timed path's decode, after the window.

Traffic keys: ``k``, ``format``, ``warmup_bodies``, ``start_steps``,
``samples``, ``sample_range``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

__all__ = ["Loop"]


class Loop:
    unit = "multiplies"
    MULTIPLY_SPAN = "bench.body"

    def __init__(self, config, traffic, inputs, device, wrap=None):
        self.traffic, self.inputs = traffic, inputs
        self.device = torch.device(device)
        # Tests and the control: (enc, body, dec) -> what runs in their place.
        self._wrap = wrap
        rng = np.random.default_rng([inputs.seed, 1])
        lo, hi = traffic["sample_range"]
        drawn = rng.choice(np.arange(lo, hi), size=traffic["samples"],
                           replace=False)
        self.start_steps = int(traffic["start_steps"])
        self.sample_at = set(range(self.start_steps)) | {int(i) for i in drawn}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def setup(self, clock) -> None:
        from sparsematrixmultiplicationmpi_tpu_torch.formats.matrix import CSR
        from sparsematrixmultiplicationmpi_tpu_torch.ops.auto import route_kernels
        from sparsematrixmultiplicationmpi_tpu_torch.parallel.strategies import Auto

        a = self.inputs.matrix
        csr = CSR.from_arrays(a.values, a.col_indices, a.row_ptr, a.shape)
        with clock("format_build_s"):
            strategy = Auto(**self.traffic["format"])
            self.op = strategy.prepare(csr, self.device)
            self._sync()
        k = self.traffic["k"]
        self.route = describe(self.op, route_kernels(self.op, k))
        enc, body, dec = strategy.chain_parts(self.op)
        if self._wrap is not None:
            enc, body, dec = self._wrap(enc, body, dec)
        self.enc, self.body, self.dec = enc, body, dec
        with clock("warmup_s"):
            v0 = torch.from_numpy(self.inputs.v0).to(self.device)
            x = enc(v0, self.op)
            for _ in range(int(self.traffic["warmup_bodies"])):
                x = body(x, self.op)
            dec(x, self.op)
            self.x0 = enc(v0, self.op)
            self._sync()

    def window(self, seconds: float, span) -> dict:
        body, op, keep = self.body, self.op, self.sample_at
        x, n, kept = self.x0, 0, {}
        t0 = time.perf_counter()
        deadline = t0 + seconds
        with span("bench.window"):
            while True:
                with span(self.MULTIPLY_SPAN):
                    y = body(x, op)
                if n in keep:
                    kept[n] = (x, y)
                x_prev, x = x, y
                n += 1
                if time.perf_counter() >= deadline:
                    break
            self._sync()
        t1 = time.perf_counter()
        kept[n - 1] = (x_prev, x)
        self.x0 = None
        self._kept = kept
        return {"attempted": n, "seconds": t1 - t0}

    def samples(self) -> dict:
        """The kept states decoded on the host (float32), then released."""
        dec, op = self.dec, self.op

        def host(x):
            return dec(x, op).float().cpu().numpy()

        kept, self._kept = self._kept, None
        start = [host(kept[i][1]) for i in range(self.start_steps)
                 if i in kept]
        steps = [(i, host(x), host(y)) for i, (x, y) in sorted(kept.items())
                 if i >= self.start_steps]
        return {"start": start, "steps": steps}

    def close(self) -> None:
        self.op = self.enc = self.body = self.dec = None


def describe(op, kernels) -> str:
    """One line: the format ``Auto`` picked, its tiling and its kernels."""
    parts = [type(op).__name__]
    for f in ("block_rows", "chunk_cols", "pairs_per_step"):
        if hasattr(op, f):
            parts.append(f"{f}={getattr(op, f)}")
    if hasattr(op, "spill"):
        parts.append(f"spill={'yes' if op.spill is not None else 'no'}")
    if hasattr(op, "phases"):
        parts.append(f"phases={'yes' if op.phases is not None else 'no'}")
    parts.append("kernels=" + ("+".join(kernels) if kernels else "none"))
    return " ".join(parts)


def end_to_end(counters: dict, nnz: int) -> dict:
    """Stored entries times multiplies completed, over the window's
    seconds (host clock, the window ending in a synchronize)."""
    return {"gnnz_per_s": nnz * counters["attempted"] / counters["seconds"]
            / 1e9}
