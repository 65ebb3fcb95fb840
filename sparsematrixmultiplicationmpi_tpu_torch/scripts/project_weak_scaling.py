"""Weak-scaling projection from counted collective bytes (port of the
JAX package's ``scripts/project_weak_scaling.py``; its arithmetic, with
published H100 link figures in place of the TPU's).

    python -m sparsematrixmultiplicationmpi_tpu_torch.scripts.project_weak_scaling \
        [--out-dir DIR] [--rate-from SWEEP_JSON] [--bytes-from JSON]

Combines

* per-rank collective bytes counted by ``run_scaling_sweep``
  (``collective_bytes.json``: ``utils/collectives.py`` counts the bytes
  each collective moves at p in {2, 4, ...}; the programs are the ones a
  multi-card run issues),
* the card's measured single-device rate: the cop20k ``auto`` row at
  k = 32 of a results sweep on the card (``h100_sweep.json``; a CPU
  record is refused),
* published interconnect figures for the H100 SXM (below),

into a projected weak-scaling efficiency per strategy. Weak scaling: the
per-rank shard is the fixture matrix itself, so per-rank compute time is
constant and

    t(p)      = t_compute + t_comm(p)
    t_comm(p) = sum over collectives of bytes_c / BW + count_c * hops * LAT
    eff(p)    = t_compute / t(p)

with ``t_compute`` = fixture nnz / the measured rate. A permute pays one
hop, the other collectives ``log2(p)``. Rank counts past the largest
counted one reuse its bytes (an upper bound for halo rows). Writes
``WEAK_SCALING.md``; every figure in it is a projection, not a
measurement. Touches no device.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

from . import _common

__all__ = ["main", "t_comm", "efficiency", "chained_rows", "headline_rate",
           "NETWORKS"]

#: NVLink 4 on the H100 SXM: 900 GB/s per GPU in both directions together
#: (NVIDIA H100 Tensor Core GPU datasheet), so 450 GB/s each way.
NVLINK_BW = 450e9
#: NDR InfiniBand: 400 Gb/s per port (NVIDIA ConnectX-7 / Quantum-2 NDR
#: datasheets), 50 GB/s each way, one port per GPU.
IB_BW = 400e9 / 8
#: Per-hop collective latencies: assumptions of this model (NCCL's
#: per-step launch and link latency, order of magnitude), not published
#: constants.
NVLINK_LAT = 5e-6
IB_LAT = 10e-6
NETWORKS = (("NVLink", NVLINK_BW, NVLINK_LAT), ("InfiniBand", IB_BW, IB_LAT))

HOPS = {  # collective launch hops in the t_comm model
    "collective-permute": 1,
    "all-gather": None,   # log2(p)
    "all-reduce": None,
    "reduce-scatter": None,
}
#: ``row_wise`` reads a replicated fat vector, so a chained step pays the
#: gather that only its gathered program shows; every other strategy's
#: output sharding is its input sharding, so its ungathered program is
#: the chained step.
CHAINED_USES_GATHERED = {"row_wise"}
PS = (2, 4, 8, 16)


def _hops(kind: str, p: int) -> int:
    fixed = HOPS.get(kind, 1)
    return fixed if fixed is not None else max(1, int(math.log2(p)))


def t_comm(collectives: dict, p: int, bw: float, lat: float) -> float:
    t = 0.0
    for kind, rec in collectives.items():
        t += rec["bytes"] / bw + rec["count"] * _hops(kind, p) * lat
    return t


def efficiency(nnz: int, rate: float, collectives: dict, p: int,
               bw: float, lat: float) -> float:
    """Projected weak-scaling efficiency at ``p`` ranks of a fixture of
    ``nnz`` entries multiplied at ``rate`` nnz/s on one card."""
    t_c = nnz / rate
    return t_c / (t_c + t_comm(collectives, p, bw, lat))


def chained_rows(records) -> dict:
    """``{(matrix, strategy): ({p: collectives}, nnz)}`` of the programs a
    chained iterate runs (``CHAINED_USES_GATHERED``)."""
    rows = {}
    for r in records:
        if "error" in r or r["gathered"] != (
                r["strategy"] in CHAINED_USES_GATHERED):
            continue
        per_p, _ = rows.setdefault((r["matrix"], r["strategy"]),
                                   ({}, r["nnz"]))
        per_p[r["devices"]] = r["collectives"]
    return rows


def headline_rate(sweep_json: str):
    """``(Gnnz/s, device kind)`` of the cop20k ``auto`` row at k = 32 of a
    results sweep's JSON."""
    with open(sweep_json) as f:
        records = json.load(f)["records"]
    for r in records:
        if (r["matrix"] == "cop20k_like" and r["k"] == 32
                and r["strategy"] == "auto" and r["devices"] == 1
                and not r.get("error") and r["gnnz_per_s"] == r["gnnz_per_s"]
                and r["gnnz_per_s"] > 0):
            return r["gnnz_per_s"], r["device_kind"]
    raise ValueError(f"{sweep_json} holds no resolved cop20k_like k=32 auto "
                     "row")


def _table(rows, rate, nets, only=None):
    lines = []
    for (mat, strat), (per_p, nnz) in sorted(rows.items()):
        if only is not None and strat != only:
            continue
        for net, bw, lat in nets:
            effs = [efficiency(nnz, rate, per_p.get(p, per_p[max(per_p)]),
                               p, bw, lat) for p in PS]
            lines.append((mat, strat, net, effs))
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="project_weak_scaling", description=__doc__.split("\n\n")[0])
    ap.add_argument("--out-dir", default=_common.RESULTS_DIR)
    ap.add_argument("--rate-from", default=None,
                    help="a results sweep's JSON (default: "
                         "<out-dir>/h100_sweep.json)")
    ap.add_argument("--bytes-from", default=None,
                    help="run_scaling_sweep's collective bytes (default: "
                         "<out-dir>/collective_bytes.json)")
    args = ap.parse_args(argv)
    rate_from = args.rate_from or os.path.join(args.out_dir,
                                               "h100_sweep.json")
    bytes_from = args.bytes_from or os.path.join(args.out_dir,
                                                 "collective_bytes.json")
    try:
        gnnz, kind = headline_rate(rate_from)
        with open(bytes_from) as f:
            audit = json.load(f)["records"]
    except (OSError, ValueError, KeyError) as e:
        return _common.refuse("project_weak_scaling", str(e))
    if kind == "cpu":
        return _common.refuse("project_weak_scaling",
                              "refusing to project from a CPU rate")
    rate = gnnz * 1e9
    rows = chained_rows(audit)
    counted = sorted({p for per_p, _ in rows.values() for p in per_p})

    lines = ["# Projected weak-scaling efficiency (a projection, not a "
             "measurement)", "",
             f"PROJECTION. Generated by `python -m "
             f"sparsematrixmultiplicationmpi_tpu_torch.scripts."
             f"project_weak_scaling` from `{os.path.basename(bytes_from)}` "
             f"(collective bytes counted per rank at p ∈ {counted}; larger "
             f"p reuse the largest counted p's bytes, an upper bound for "
             f"halo rows) and the measured single-card rate {gnnz} Gnnz/s "
             f"(`{os.path.basename(rate_from)}`, {kind}, cop20k k = 32 "
             f"`auto`). Chained iterate, result left sharded: the "
             f"solver / GNN regime.", "",
             "Links: NVLink 4, 900 GB/s per GPU both ways (450 GB/s each "
             "way), and NDR InfiniBand, 400 Gb/s per port (NVIDIA "
             "datasheets); per-hop latencies "
             f"{NVLINK_LAT * 1e6:g} µs and {IB_LAT * 1e6:g} µs are this "
             "model's assumptions. No multi-card run was measured.", ""]
    for net, bw, lat in NETWORKS:
        lines += [f"## {net} ({bw / 1e9:.2f} GB/s, {lat * 1e6:g} µs a hop) "
                  "— projected", "",
                  "| matrix | strategy | "
                  + " | ".join(f"p={p}" for p in PS) + " |",
                  "|---|---|" + "---|" * len(PS)]
        for mat, strat, _, effs in _table(rows, rate, [(net, bw, lat)]):
            lines.append(f"| {mat} | {strat} | "
                         + " | ".join(f"{e * 100:.1f}%" for e in effs)
                         + " |")
        lines.append("")
    slow = [(f"{net}/10", bw / 10, lat * 10) for net, bw, lat in NETWORKS]
    lines += ["## Sensitivity (windowed_row_wise rows, links 10× slower) — "
              "projected", "",
              "| matrix | link | " + " | ".join(f"p={p}" for p in PS)
              + " |", "|---|---|" + "---|" * len(PS)]
    for mat, _, net, effs in _table(rows, rate, slow,
                                    only="windowed_row_wise"):
        lines.append(f"| {mat} | {net} | "
                     + " | ".join(f"{e * 100:.1f}%" for e in effs) + " |")
    lines.append("")
    verdict = {net: all(min(effs) >= 0.70 for *_, effs in _table(
        rows, rate, [(net, bw, lat)], only="windowed_row_wise"))
        for net, bw, lat in NETWORKS}
    lines += ["## The ≥ 70 % claim, under this projection", "",
              "* `windowed_row_wise` (halo / replicate): "
              + ", ".join(f"{'SUPPORTED' if ok else 'NOT SUPPORTED'} on "
                          f"{net}" for net, ok in verdict.items())
              + ", under the stated model.",
              "* A projection: the bytes are counted, the link figures "
              "published, the rate measured on one card; no multi-card "
              "run stands behind these numbers.", ""]
    out = os.path.join(args.out_dir, "WEAK_SCALING.md")
    os.makedirs(args.out_dir, exist_ok=True)
    with open(out, "w") as f:
        f.write("\n".join(lines))
    print(f"wrote {out}")
    print("\n".join(lines[:40]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
