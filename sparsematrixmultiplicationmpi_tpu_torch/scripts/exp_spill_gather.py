"""The card's spill route: kernel B7 against the take route on real spill
geometries, and the per-entry and per-row spill costs.

    python -m sparsematrixmultiplicationmpi_tpu_torch.scripts.exp_spill_gather

The port's counterpart of the JAX package's ``scripts/exp_spill_gather.py``.
Two spills: the cop20k stand-in's U = 2 build (the tiling the
reference picks, R = C = 256, a spill of short rows) and ``powerlaw_100k`` pinned to R =
256, C = 512 (a wide one), at k in (1, 32). For each, the bucketed spill
is gathered (``stack_bucketed``) through B7 and through the take route,
each checked against the f64 oracle of the spill alone and timed with
CUDA events; then the m-row restore (``index_select`` of the stacked
table and the add) is timed alone. ``spill_dma_gather`` is whether B7
wins on every case; ``gather_s_per_row`` is the chosen route's time per
spilled entry and ``spill_restore_s_per_row`` the restore's per output
row, each the median over the cases. Writes ``spill_gather.json``.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..formats.windowed import WindowedPairs
from ..ops.ell import stack_bucketed
from ..parallel.banded_strategy import _bucketed_to_csr
from . import _common, _probe

KS = (1, 32)


def spills(scale: float):
    """(label, host WindowedPairs with a spill)."""
    for label, name, R, C, U in (
            ("cop20k_u2", "cop20k_like", 256, 256, 2),
            ("powerlaw_100k_r256_c512", "powerlaw_100k", 256, 512, 16)):
        csr = _probe.matrix(name, scale)
        yield label, csr, WindowedPairs.from_csr(
            csr, block_rows=R, chunk_cols=C, pairs_per_step=U,
            max_inflation=1e9, beat_gather_margin=1e9)


def measure(scale: float, dev, ks=KS) -> list:
    rows = []
    for label, csr, host in spills(scale):
        if host.spill is None:
            print(f"{label}: no spill at this size", flush=True)
            continue
        spill = host.spill
        spill_csr = _bucketed_to_csr(spill)
        m = csr.shape[0]
        bell = spill.to(dev)
        entries = spill_csr.nnz
        slots = sum(b.m_padded * b.width for b in spill.buckets)
        for k in ks:
            v_host, v = _probe.fat_vector(csr.shape[1], k, dev)
            check = _probe.Checked(spill_csr, v_host)
            times = {}
            for route, b7 in (("b7", True), ("take", False)):
                def gather(b7=b7):
                    return stack_bucketed(bell, v, dma_gather=b7)

                if not check.ok(gather().index_select(0, bell.inv_row_perm)):
                    raise RuntimeError(f"{label} k={k} {route}: "
                                       "disagrees with spmm_host_f64")
                times[route] = _probe.seconds(gather, dev)
            stacked = stack_bucketed(bell, v)
            out = torch.zeros((m, k), device=dev)
            idx = bell.inv_row_perm
            restore = _probe.seconds(
                lambda: out + stacked.index_select(0, idx), dev)
            rows.append({"spill": label, "k": k, "m": m, "entries": entries,
                         "slots": int(slots), "buckets": len(spill.buckets),
                         "b7_s": times["b7"], "take_s": times["take"],
                         "restore_s": restore})
            print(f"{label} k={k}: {entries} entries in {len(spill.buckets)}"
                  f" buckets; B7 {times['b7'] * 1e3:.4f} ms, take "
                  f"{times['take'] * 1e3:.4f} ms, restore "
                  f"{restore * 1e3:.4f} ms", flush=True)
    return rows


def decide(rows) -> dict:
    b7 = all(r["b7_s"] < r["take_s"] for r in rows)
    per_entry = [(r["b7_s"] if b7 else r["take_s"]) / r["entries"]
                 for r in rows]
    return {"spill_dma_gather": b7,
            "gather_s_per_row": float(np.median(per_entry)),
            "spill_restore_s_per_row": float(np.median(
                [r["restore_s"] / r["m"] for r in rows]))}


def main(argv=None) -> int:
    prog = "exp_spill_gather"
    ap = _probe.parser(prog, __doc__)
    ap.add_argument("--ks", type=int, nargs="+", default=list(KS))
    args = ap.parse_args(argv)
    dev = _probe.device_of(prog, args)
    if isinstance(dev, int):
        return dev
    rows = measure(args.scale, dev, args.ks)
    if not rows:
        return _common.refuse(prog, "no build spilled at this size")
    decision = decide(rows)
    print(decision)
    _probe.write(args, "spill_gather", {"rows": rows, **decision})
    return 0


if __name__ == "__main__":
    sys.exit(main())
