"""The card's band gate and the band / windowed / gather boundary.

    python -m sparsematrixmultiplicationmpi_tpu_torch.scripts.exp_auto_threshold
    python -m sparsematrixmultiplicationmpi_tpu_torch.scripts.exp_auto_threshold \\
        --estimates results/h100/auto_threshold.json

The port's counterpart of the JAX package's
``scripts/exp_auto_threshold_tpu.py``. Part one: the results sweep's
``fem_banded_100k`` built as ``BandedBlocks`` at block_rows 128, 256 and
512, each multiplied at k in (1, 8, 16, 32, 128) through the band kernel
B5 (which takes block_rows <= 128) and through ``spmm_banded`` (batched
matmuls), checked against the f64 oracle and timed with CUDA events in
turns. ``max_kernel_block_rows`` is the widest block_rows at which B5
beats ``spmm_banded`` at k = 1 (0 if it never does); B5 then takes
every width there (``b5_loses_at_k`` lists the widths at which it is
the slower: B5 reads its band once per ``BAND_K_CHUNK`` columns, the
matmuls once). ``band_matmul_bw`` is the rate the band estimate
(``formats/banded.py``) needs to give the matmuls' times on the
spill-free builds past the gate: the band's bytes
over the time less the estimate's other terms (the table's ``call_s``
and the output's bytes), the median over builds and widths.
``band_spill_s`` is what B5's spilled builds at the gate measure beyond
their estimate without it (the spill's gather and restore launch
whatever the spill's size), the median over their widths.

Part two, one-shot callers (``auto_format(one_shot=True)``): on the
models benchmark's CG system and the cop20k stand-in at k in (1, 8,
32), the H100 table's windowed and band candidates each timed as one
``spmm_any`` (encode, body, decode) and as one body of ``Auto``'s
chain, in turns; ``one_shot_s`` is what a one-shot windowed multiply
adds, the median over the operands and widths. ``band_bw`` is B5's
rate the same way, over the chain bodies of the spill-free bands the
gate sends to it (the CG system's), the band read once per
``band_k_cols`` columns.

Part three, the boundary ``Auto._mesh_route`` prices: the reference's
ladder (a band of half-width 150 with 12 entries a row on 30,000 rows,
plus a uniform off-band share of 0 to 75 % of the entries), each rung's
best gather format, band build and windowed build (as the device's
table builds them) at k = 32: one body of ``Auto``'s chain, checked and
timed in turns; the table's estimates beside them, and whether its cheapest is
the measured fastest. ``--estimates`` recomputes the gate, ``band_bw``, ``one_shot_s`` and
the ladder's estimates of a card's file under the current H100 table
(host only). Writes ``auto_threshold.json``.
"""

from __future__ import annotations

import dataclasses
import json
import sys

import numpy as np
import scipy.sparse as sp

from ..bench.systems import spd_banded_system
from ..formats.banded import (
    BandedBlocks, _band_passes, _band_stream_s, band_coverage,
)
from ..formats.cost import H100, cost_table_for
from ..formats.matrix import CSR
from ..io.generate import banded_csr, random_csr
from ..ops.auto import route_candidates, spmm_any
from ..ops.banded import spmm_banded
from . import _probe

BLOCK_ROWS = (128, 256, 512)
GATE_KS = (1, 8, 16, 32, 128)
M = 30_000
K = 32
FRACS = (0.0, 0.1, 0.25, 0.4, 0.55, 0.75)


def mixed_csr(off_band_frac: float, seed: int = 0, m: int = M) -> CSR:
    """A band plus uniform off-band entries (the reference's ladder)."""
    base = banded_csr(m, 150, 12, seed=seed)
    if off_band_frac <= 0:
        return base
    n_off = int(base.nnz * off_band_frac / (1 - off_band_frac))
    rnd = random_csr(m, m, n_off, seed=seed + 1)
    a, b = (sp.csr_matrix((np.asarray(x.values), np.asarray(x.col_indices),
                           np.asarray(x.row_ptr)), shape=x.shape)
            for x in (base, rnd))
    s = (a + b).tocsr()
    return CSR.from_arrays(s.data, s.indices, s.indptr, base.shape)


def _priced_rest(csr, r: int, k: int) -> float:
    """The H100 band estimate of ``csr`` at ``block_rows = r``, width
    ``k``, less its band stream and ``band_spill_s``: the terms (fixed
    call, output, spill) that ``band_spill_s`` is fitted beside."""
    table = dataclasses.replace(H100, band_spill_s=0.0)
    bb = BandedBlocks.from_csr(csr, block_rows=r, k_nominal=k,
                               cost_table=table)
    return bb.est_seconds - _band_stream_s(table, r, k, bb.dense_bytes)


def band_gate(scale: float, dev) -> list:
    from ..ops.cuda_banded import MAX_KERNEL_BLOCK_ROWS, spmm_banded_cuda

    csr = _probe.matrix("fem_banded_100k", scale)
    rows = []
    for r in BLOCK_ROWS:
        bb = BandedBlocks.from_csr(csr, block_rows=r)
        op = bb.to(dev)
        for k in GATE_KS:
            v_host, v = _probe.fat_vector(csr.shape[1], k, dev)
            check = _probe.Checked(csr, v_host)
            routes = {"banded_s": lambda: spmm_banded(op, v)}
            if r <= MAX_KERNEL_BLOCK_ROWS:
                routes["b5_s"] = lambda: spmm_banded_cuda(op, v)
            for key, fn in routes.items():
                if not check.ok(fn()):
                    raise RuntimeError(f"band r={r} k={k} {key}: disagrees "
                                       "with spmm_host_f64")
            row = {"block_rows": r, "k": k, "band_bytes": bb.dense_bytes,
                   "m": csr.shape[0], "spill": bb.spill is not None,
                   **dict(zip(routes, _probe.seconds_each(
                       list(routes.values()), dev)))}
            if "b5_s" in row and row["spill"]:
                row["priced_rest_s"] = _priced_rest(csr, r, k)
            rows.append(row)
            print(f"band r={r} k={k}: " + ", ".join(
                f"{key} {row[key] * 1e3:.4f} ms"
                for key in ("b5_s", "banded_s") if key in row), flush=True)
    return rows


def _rate(table, x, seconds: float) -> float:
    """The band rate at which the band estimate gives ``seconds`` for the
    spill-free build ``x``: its bytes, times its reads, over the time
    less the estimate's other terms."""
    rest = table.call_s + 4 * x["m"] * x["k"] * 4 / table.hbm_bw
    return (x["band_bytes"] * _band_passes(table, x["block_rows"], x["k"])
            / (seconds - rest))


def gate_decision(rows, shots=()) -> dict:
    k1 = [x for x in rows if "b5_s" in x and x["k"] == min(GATE_KS)]
    wins = [x["block_rows"] for x in k1 if x["b5_s"] < x["banded_s"]]
    gate = max(wins) if wins else 0
    table = dataclasses.replace(H100, max_kernel_block_rows=gate)
    out = {"max_kernel_block_rows": gate,
           "b5_loses_at_k": sorted({x["k"] for x in rows
                                    if x["block_rows"] <= gate
                                    and x["b5_s"] >= x["banded_s"]})}
    matmul = [_rate(table, x, x["banded_s"]) for x in rows
              if x["block_rows"] > gate and not x["spill"]]
    kernel = [_rate(table, x, x["body_s"]) for x in shots
              if x["class"] == "banded" and x["block_rows"] <= gate
              and not x["spill"]]
    if matmul:
        out["band_matmul_bw"] = float(np.median(matmul))
    if kernel:
        out["band_bw"] = float(np.median(kernel))
        table = dataclasses.replace(table, band_bw=out["band_bw"])
        spilled = [x["b5_s"] - _band_stream_s(table, x["block_rows"], x["k"],
                                             x["band_bytes"])
                   - x["priced_rest_s"] for x in rows
                   if "priced_rest_s" in x and x["block_rows"] <= gate]
        if spilled:
            out["band_spill_s"] = float(np.median(spilled))
    return out


ONE_SHOT_KS = (1, 8, 32)


def one_shot(scale: float, dev) -> list:
    """Each H100 windowed and band candidate of the CG system and the
    cop20k stand-in, one-shot against one chain body."""
    from ..io.generate import cop20k_like

    rows = []
    for name, csr in (("cg_spd121k", spd_banded_system(
            max(int(121_192 * scale), 1000))),
            ("cop20k_like", cop20k_like(scale=scale, dtype=np.float32))):
        for k in ONE_SHOT_KS:
            cands = [c for c in route_candidates(
                csr, k_nominal=k, cost_table=H100)[2:] if c[2] is not None]
            v_host, v = _probe.fat_vector(csr.shape[1], k, dev)
            check = _probe.Checked(csr, v_host)
            fns = []
            for cls, _, host in cands:
                op = host.to(dev)

                def call(op=op):
                    return spmm_any(op, v)

                if not check.ok(call()):
                    raise RuntimeError(f"{name} k={k} {cls} one-shot: "
                                       "disagrees with spmm_host_f64")
                fns += [call, _probe.chain_body(f"{name} k={k} {cls}", op,
                                                v, check)]
            times = _probe.seconds_each(fns, dev)
            for i, (cls, _, host) in enumerate(cands):
                row = {"matrix": name, "k": k, "class": cls,
                       "m": csr.shape[0], "one_shot_s": times[2 * i],
                       "body_s": times[2 * i + 1]}
                if cls == "banded":
                    row.update(block_rows=host.block_rows,
                               band_bytes=host.dense_bytes,
                               spill=host.spill is not None)
                rows.append(row)
                print(f"{name} k={k} {cls}: one-shot "
                      f"{times[2 * i] * 1e3:.4f} ms, chain body "
                      f"{times[2 * i + 1] * 1e3:.4f} ms", flush=True)
    return rows


def one_shot_decision(rows) -> dict:
    """``one_shot_s``: the median of a windowed operand's one-shot time
    less its chain body's."""
    extra = [r["one_shot_s"] - r["body_s"] for r in rows
             if r["class"] == "windowed"]
    return {"one_shot_s": float(np.median(extra)) if extra else 0.0}


def _estimates(csr, table) -> dict:
    cands = route_candidates(csr, k_nominal=K, cost_table=table)
    gname, gest, gop = min(cands[:2], key=lambda c: c[1])
    ests = {f"gather_{gname}": (gest, gop)}
    for name, est, op in cands[2:]:
        if op is not None:
            ests[name] = (est, op)
    return ests


def ladder(dev, m: int = M) -> list:
    table = cost_table_for(dev)
    rows = []
    for frac in FRACS:
        csr = mixed_csr(frac, seed=int(frac * 100), m=m).astype(np.float32)
        v_host, v = _probe.fat_vector(m, K, dev, seed=1)
        check = _probe.Checked(csr, v_host)
        ests = _estimates(csr, table)
        row = {"off_band_frac": frac, "band_coverage": band_coverage(csr, 128),
               "nnz": csr.nnz, "table": table.name,
               "model_est_ms": {n: e * 1e3 for n, (e, _) in ests.items()},
               "measured_ms": {}}
        bodies = [_probe.chain_body(f"frac={frac} {name}", op.to(dev), v,
                                    check) for name, (_, op) in ests.items()]
        row["measured_ms"] = {name: s * 1e3 for name, s in zip(
            ests, _probe.seconds_each(bodies, dev))}
        _winners(row)
        rows.append(row)
        print(f"off-band {frac}: measured {row['measured_ms']}, model "
              f"{row['model_est_ms']}, match {row['model_matches']}",
              flush=True)
    return rows


def _winners(row) -> None:
    meas, ests = row["measured_ms"], row["model_est_ms"]
    row["measured_winner"] = min(meas, key=meas.get)
    row["model_winner"] = min(ests, key=ests.get)
    row["model_matches"] = row["measured_winner"] == row["model_winner"]


def refresh(path: str) -> int:
    """Recompute a card file's decisions, and its ladder's estimates
    under the current H100 table."""
    with open(path) as f:
        data = json.load(f)
    data.update(gate_decision(data["gate"], data["one_shot"]))
    data.update(one_shot_decision(data["one_shot"]))
    for row in data["ladder"]:
        csr = mixed_csr(row["off_band_frac"],
                        seed=int(row["off_band_frac"] * 100),
                        m=data["m"]).astype(np.float32)
        ests = _estimates(csr, H100)
        row["model_est_ms"] = {n: e * 1e3 for n, (e, _) in ests.items()}
        row["table"] = H100.name
        _winners(row)
    data["model_argmin_matches"] = all(r["model_matches"]
                                       for r in data["ladder"])
    with open(path, "w") as f:
        json.dump(data, f, indent=1)
    print(f"refreshed {path}: model_argmin_matches "
          f"{data['model_argmin_matches']}")
    return 0


def main(argv=None) -> int:
    prog = "exp_auto_threshold"
    ap = _probe.parser(prog, __doc__)
    ap.add_argument("--estimates", metavar="JSON",
                    help="recompute this file's estimates and exit")
    args = ap.parse_args(argv)
    if args.estimates:
        return refresh(args.estimates)
    dev = _probe.device_of(prog, args)
    if isinstance(dev, int):
        return dev
    gate = band_gate(args.scale, dev) if dev.type == "cuda" else []
    shots = one_shot(args.scale, dev)
    rows = ladder(dev, m=max(int(M * args.scale), 1000))
    out = {"gate": gate, "one_shot": shots, "ladder": rows,
           "m": max(int(M * args.scale), 1000), "k": K,
           "model_argmin_matches": all(r["model_matches"] for r in rows)}
    if gate:
        out.update(gate_decision(gate, shots))
    out.update(one_shot_decision(shots))
    print({key: out.get(key) for key in (
        "max_kernel_block_rows", "b5_loses_at_k", "band_bw",
        "band_matmul_bw", "band_spill_s", "one_shot_s",
        "model_argmin_matches")})
    _probe.write(args, "auto_threshold", out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
