"""The card's windowed-kernel cost fit: B2 + B1 (and B3 at U = 2) over
pairs per step and tile shapes, and the constants of the H100 table's
windowed estimate.

    python -m sparsematrixmultiplicationmpi_tpu_torch.scripts.fit_probe17
    python -m sparsematrixmultiplicationmpi_tpu_torch.scripts.fit_probe17 \\
        --fit results/h100/probe17_fit.json

The port's counterpart of the JAX package's ``scripts/exp_kernel_probe17.py``
and ``fit_probe17.py`` in one script. The probe builds the cop20k
stand-in at U in {2, 4, 8, 16, 32} on (128, 128) and at U = 16 on every
shape of ``DEFAULT_CANDIDATES`` the U > 2 search admits (``R % 128 ==
0``), and ``powerlaw_100k`` pinned to R = 256, C = 512 (one block holds a
chain of 195 tiles and most of the tile entries), each at k in (8, 32,
128). For each operand it times with CUDA events, after the oracle check
of the whole chain: the windowed kernel alone (B1, or B3 at U = 2) on
prepared slabs, B2, and one body of ``Auto``'s chain; and records each
block's pairs, windows and stored entries.

The fit (run at the end, or alone with ``--fit``) is the H100 table's
windowed model (``formats/windowed.py::compact_kernel_s``): a CTA of a
block costs its windows (``tile_stream_bw``: each window stages its
pair's slab, ``C * min(k8, 32) * 4`` bytes) and its share of the block's
entries (``entry_s`` each); the kernel takes the larger of all CTAs'
work over ``ctas`` and the costliest CTA (``chain_floor`` = 1: a free
weight would trade off against the costs' scale). The U > 2 records fit
the three by least squares on the log of the time: the skewed operand's
chain sets the costs' scale, the cop20k shapes ``ctas``; the U = 2
records then fit ``tile_overhead_s``, B3's fixed cost a window (0
where the fit reaches its lower bound, 1e-12 s). The
per-step and per-pair costs of the reference's model are zero here:
B1's time does not move with U (``u_spread``, the largest over the
smallest time at (128, 128), each k). ``call_s`` is the median over the
records whose chain is not transposed of a body's time less the
kernel's and ``m * k * 4 / hbm_bw``. The fastest U at (128, 128) is the
card's ``production_pairs_per_step``. Writes ``probe17_fit.json``.
"""

from __future__ import annotations

import dataclasses
import json
import sys

import numpy as np
import torch

from ..formats.cost import H100
from ..formats.windowed import (
    DEFAULT_CANDIDATES, WindowedPairs, compact_kernel_s, tile_windows,
)
from ..ops import cuda_windowed as cw
from . import _probe

KS = (8, 32, 128)
US = (2, 4, 8, 16, 32)
#: The skewed operand: powerlaw_100k at the tiling the reference's table
#: picks for it, whose longest block chain carries most of its entries.
SKEWED = ("powerlaw_100k", 256, 512)


#: The tile shapes the U > 2 search admits.
SHAPES = tuple((R, C) for R, C in DEFAULT_CANDIDATES if R % 128 == 0)


def operands(matrices=None):
    """(matrix, R, C, U) in measuring order: the fit's set, or every
    admitted shape at U = 16 of each of ``matrices``."""
    if matrices:
        return [(name, R, C, 16) for name in matrices for R, C in SHAPES]
    out = [("cop20k_like", 128, 128, u) for u in US]
    out += [("cop20k_like", R, C, 16) for R, C in SHAPES
            if (R, C) != (128, 128)]
    out.append((SKEWED[0], SKEWED[1], SKEWED[2], 16))
    return out


def build(csr, R: int, C: int, U: int):
    """The pinned tiling, built whatever the search would say of it
    (None where no tile clears the reference's dense threshold)."""
    return WindowedPairs.from_csr(csr, block_rows=R, chunk_cols=C,
                                  pairs_per_step=U, max_inflation=1e9,
                                  beat_gather_margin=1e9)


def block_stats(host: WindowedPairs) -> dict:
    """Pairs, windows and stored entries, in all and per block (padding
    pairs included: the kernels visit them)."""
    tiles = np.asarray(host.tiles)
    entries = np.count_nonzero(tiles.reshape(tiles.shape[0], -1), axis=1)
    pb = np.asarray(host.pair_block)
    nb = host.n_blocks

    def per_block(w):
        return np.bincount(pb, weights=w, minlength=nb).astype(int).tolist()

    return {"pairs": int(len(pb)), "entries": int(entries.sum()),
            "blocks": nb, "block_pairs": per_block(None),
            "block_windows": per_block(tile_windows(entries,
                                                    host.block_rows)),
            "block_entries": per_block(entries),
            "spill_entries": 0 if host.spill is None else int(sum(
                np.count_nonzero(np.asarray(b.vals))
                for b in host.spill.buckets)),
            "t_chain": bool(host.supports_transposed_chain
                            and host.block_rows % 128 == 0)}


def kernel_fn(wp: WindowedPairs, slabs):
    """The operand's windowed kernel alone on prepared slabs."""
    nb = wp.n_blocks
    if wp.pairs_per_step <= 2:
        return lambda: cw.windowed_matmul_split3(
            wp.pair_block, wp.pair_chunk, wp.block_ptr, wp.natural_plane,
            slabs, nb=nb)
    return lambda: cw.windowed_matmul_tmulti(
        wp.pair_block, wp.pair_chunk, wp.block_ptr, wp.tiles_t, slabs,
        nb=nb, pairs_per_step=wp.pairs_per_step, split=wp.split)


def measure(scale: float, dev, ks=KS, matrices=None) -> list:
    records = []
    csrs = {}
    for name, R, C, U in operands(matrices):
        csr = csrs.get(name)
        if csr is None:
            csr = csrs.setdefault(name, _probe.matrix(name, scale))
        if R > max(csr.shape[0], 8):
            continue
        host = build(csr, R, C, U)
        if host is None:
            print(f"{name} R={R} C={C} U={U}: no dense tile", flush=True)
            continue
        stats = block_stats(host)
        wp = host.to(dev)
        del host
        for k in ks:
            v_host, v = _probe.fat_vector(csr.shape[1], k, dev)
            check = _probe.Checked(csr, v_host)
            label = f"{name} R={R} C={C} U={U} k={k}"
            body = _probe.chain_body_seconds(label, wp, v, check, dev)
            v_p = wp.encode(v)
            if k % 8:  # the kernels' padded width, as the card runs it
                v_p = torch.cat([v_p, v_p.new_zeros(
                    (v_p.shape[0], (-k) % 8))], dim=1)
            v_p = v_p.contiguous()
            slabs = cw.chunk_slabs(v_p, C=C, split=wp.split)
            b2 = _probe.seconds(
                lambda: cw.chunk_slabs(v_p, C=C, split=wp.split), dev)
            kern = _probe.seconds(kernel_fn(wp, slabs), dev)
            rec = {"matrix": name, "R": R, "C": C, "U": U, "k": k,
                   "m": csr.shape[0], "itemsize": 4,
                   "spill": wp.spill is not None, "kernel_s": kern,
                   "b2_s": b2, "body_s": body, **stats}
            records.append(rec)
            print(f"{label}: kernel {kern * 1e3:.4f} ms, B2 "
                  f"{b2 * 1e3:.4f}, chain body {body * 1e3:.4f}; "
                  f"{stats['pairs']} pairs, {stats['entries']} entries, "
                  f"longest chain {max(stats['block_pairs'])} pairs",
                  flush=True)
        del wp
        torch.cuda.empty_cache() if dev.type == "cuda" else None
    return records


NAMES = ("tile_stream_bw", "entry_s", "ctas")


def model_seconds(r, p: dict) -> float:
    """The table's kernel time of one record under constants ``p``."""
    table = dataclasses.replace(H100, **p)
    return compact_kernel_s(r["block_windows"], r["block_entries"], r["R"],
                            r["C"], r["itemsize"], r["k"], r["U"], table)


def fit(records) -> dict:
    from scipy.optimize import least_squares

    multi = [r for r in records if r["U"] > 2]
    if len(multi) < len(NAMES):
        raise ValueError(f"need >= {len(NAMES)} U > 2 records, have "
                         f"{len(multi)}")
    zero = dict(tmulti_step_s=0.0, tmulti_pair_s=0.0, tile_overhead_s=0.0,
                chain_floor=1.0)

    def resid(x, names, base, rows):
        q = dict(base, **dict(zip(names, np.exp(x))))
        return [np.log(model_seconds(r, q) / r["kernel_s"]) for r in rows]

    sol = least_squares(resid, np.log([10e9, 30e-9, 500.0]),
                        args=(NAMES, zero, multi))
    p = dict(zero, **{n: float(v) for n, v in zip(NAMES, np.exp(sol.x))})
    two = [r for r in records if r["U"] <= 2]
    if two:
        sol2 = least_squares(resid, [np.log(100e-9)],
                             args=(("tile_overhead_s",), p, two),
                             bounds=([np.log(1e-12)], [np.log(1e-4)]))
        fixed = float(np.exp(sol2.x[0]))
        # At the bound: B3's windows cost no more than their staging.
        p["tile_overhead_s"] = fixed if fixed > 2e-12 else 0.0
    calls = [r["body_s"] - r["kernel_s"] - r["m"] * r["k"] * 4 / H100.hbm_bw
             for r in records if not r["t_chain"] and not r["spill"]]
    p["call_s"] = max(float(np.median(calls)), 0.0) if calls else 0.0
    at128 = [r for r in records if (r["matrix"], r["R"], r["C"]) == (
        "cop20k_like", 128, 128) and r["U"] > 2]
    u_spread = {}
    for k in sorted({r["k"] for r in at128}):
        ts = [r["kernel_s"] for r in at128 if r["k"] == k]
        u_spread[str(k)] = max(ts) / min(ts)
    best_u = None
    if at128:
        k32 = [r for r in at128 if r["k"] == 32] or at128
        best_u = min(k32, key=lambda r: r["body_s"])["U"]
    rows = []
    for r in records:
        est = model_seconds(r, p)
        rows.append({key: r[key] for key in ("matrix", "R", "C", "U", "k")}
                    | {"kernel_s": r["kernel_s"], "model_s": est,
                       "ratio": est / r["kernel_s"],
                       "chain_pairs": max(r["block_pairs"]),
                       "chain_entries": max(r["block_entries"])})
    ratios = [row["ratio"] for row in rows]
    return {"constants": p, "production_pairs_per_step": best_u,
            "u_spread": u_spread,
            "ratio_range": [min(ratios), max(ratios)], "rows": rows}


def main(argv=None) -> int:
    prog = "fit_probe17"
    ap = _probe.parser(prog, __doc__)
    ap.add_argument("--fit", metavar="JSON",
                    help="refit this file's records and rewrite it")
    ap.add_argument("--ks", type=int, nargs="+", default=list(KS))
    ap.add_argument("--matrices", nargs="+", choices=list(_probe.FAMILIES),
                    help="measure every admitted shape at U = 16 of these "
                         "matrices instead of the fit's set (written as "
                         "probe17_shapes.json, not fitted)")
    args = ap.parse_args(argv)
    if args.fit:
        with open(args.fit) as f:
            data = json.load(f)
        data["fit"] = fit(data["records"])
        with open(args.fit, "w") as f:
            json.dump(data, f, indent=1)
        print(json.dumps(data["fit"]["constants"]))
        return 0
    dev = _probe.device_of(prog, args)
    if isinstance(dev, int):
        return dev
    records = measure(args.scale, dev, ks=args.ks, matrices=args.matrices)
    if args.matrices:
        _probe.write(args, "probe17_shapes", {"records": records})
        return 0
    result = fit(records)
    print(json.dumps(result["constants"]))
    print(f"production_pairs_per_step {result['production_pairs_per_step']}"
          f"; model/measured {result['ratio_range']}; U spread "
          f"{result['u_spread']}")
    _probe.write(args, "probe17_fit", {"records": records, "fit": result})
    return 0


if __name__ == "__main__":
    sys.exit(main())
