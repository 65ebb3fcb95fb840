"""The card's gather-route calibration: COO and bucketed-ELL SpMM times
over the results sweep's matrices and the reference's two smaller
calibration matrices, at k in (1, 6, 32).

    python -m sparsematrixmultiplicationmpi_tpu_torch.scripts.exp_gather_calib3
    python -m sparsematrixmultiplicationmpi_tpu_torch.scripts.exp_gather_calib3 \\
        --render results/h100/gather_calib3.json

The port's counterpart of the JAX package's ``scripts/exp_gather_calib3.py``.
Each record is one ``spmm_any``-style call timed with CUDA events (the
best of five rounds of 20 back-to-back calls, the three routes timed in
turns) after its result passed the f64 oracle: ``spmm_coo`` on the COO
operand, and ``spmm_bucketed`` on the ``BucketedELL`` operand through
the take route and through kernel B7.
Writes ``gather_calib3.json`` (``(path, m, work, k, seconds)`` with work =
nnz for COO and padded slots for ELL, and ``width``: the longest row
for COO, the widest bucket for ELL). ``--render`` turns a card's file
into ``formats/_gather_calib_h100.py``: the COO records and the ELL
records of the route the H100 table takes (its ``spill_dma_gather``, as
``exp_spill_gather.py`` decided: B7 or the take route), and the linear
model the table prices the gather routes with (``GATHER_COEFS_H100``:
``ops/auto.py::gather_features``' coefficients, a non-negative least
squares fit of the records in relative error). It also writes into the
JSON the model (``fit``: its coefficients, its estimate over each
record's time, and the same with each matrix's records left out of the
fit that estimates them) and the linear floors under the records
(``floors``: the least seconds per nnz of the COO records and per slot
of the route's ELL records), the table's ``coo_s_per_nnz`` and
``ell_s_per_slot``. A file written before records carried ``width``
gets it from each named matrix, rebuilt at the file's scale.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

import numpy as np

from ..formats.cost import H100
from ..formats.matrix import BucketedELL
from ..io.generate import random_csr, roadnet_like
from ..ops.auto import _calibrated_gather_seconds, gather_features
from ..ops.ell import spmm_bucketed
from ..ops.oracle import spmm_coo
from . import _common, _probe

KS = (1, 6, 32)
#: The reference probe's matrices below the sweep's sizes (its
#: ``families()``), anchors for the surface's smaller m.
SMALL = {
    "uniform_random_20k": lambda s: random_csr(
        max(int(20_000 * s), 16), max(int(20_000 * s), 16),
        max(int(200_000 * s), 16), seed=14),
    "roadnet_03": lambda s: roadnet_like(scale=0.3 * s),
}
FAMILIES = tuple(_probe.FAMILIES) + tuple(SMALL)


def _matrix(name: str, scale: float):
    if name in SMALL:
        return SMALL[name](scale).astype(np.float32)
    return _probe.matrix(name, scale)


def _widths(csr, bell) -> dict:
    """Each path's ``width`` feature: the longest row, the widest
    bucket."""
    return {"coo": int(csr.row_lengths().max(initial=0)),
            "ell": max(b.width for b in bell.buckets)}


MODULE = os.path.join(_common.ROOT, "sparsematrixmultiplicationmpi_tpu_torch",
                      "formats", "_gather_calib_h100.py")


def measure(names, ks, scale, dev) -> list:
    records = []
    for name in names:
        csr = _matrix(name, scale)
        m = csr.shape[0]
        coo = csr.to_coo().to(dev)
        bell_host = BucketedELL.from_csr(csr)
        slots = sum(b.m_padded * b.width for b in bell_host.buckets)
        widths = _widths(csr, bell_host)
        bell = bell_host.to(dev)
        for k in ks:
            v_host, v = _probe.fat_vector(csr.shape[1], k, dev)
            check = _probe.Checked(csr, v_host)
            routes = (("coo", csr.nnz, None), ("ell_take", slots, False),
                      ("ell_b7", slots, True))
            fns = []
            for path, work, b7 in routes:
                def fn(b7=b7):
                    if b7 is None:
                        return spmm_coo(coo, v)
                    return spmm_bucketed(bell, v, dma_gather=b7)

                if not check.ok(fn()):
                    raise RuntimeError(f"{name} k={k} {path}: disagrees "
                                       "with spmm_host_f64")
                fns.append(fn)
            for (path, work, _), s in zip(routes,
                                          _probe.seconds_each(fns, dev)):
                records.append({"path": path, "matrix": name, "m": m,
                                "work": int(work), "k": k, "seconds": s,
                                "buckets": len(bell_host.buckets),
                                "width": widths[path[:3]]})
                print(f"{name} k={k} {path}: {s * 1e3:.4f} ms", flush=True)
    return records


def _route_rows(records, route: str):
    """(path, record) of the COO records and the route's ELL records."""
    for r in records:
        if r["path"] == "coo" or r["path"] == f"ell_{route}":
            yield ("coo" if r["path"] == "coo" else "ell"), r


def floors(records, route: str) -> dict:
    """The least seconds per unit of work over the table's records."""
    rows = list(_route_rows(records, route))
    return {"coo_s_per_nnz": min(r["seconds"] / r["work"]
                                 for p, r in rows if p == "coo"),
            "ell_s_per_slot": min(r["seconds"] / r["work"]
                                  for p, r in rows if p == "ell")}


def add_widths(data) -> None:
    """Give every record its ``width``, rebuilding the matrices of a file
    written before records carried it."""
    cache = {}
    for r in data["records"]:
        if "width" not in r:
            if r["matrix"] not in cache:
                csr = _matrix(r["matrix"], data["scale"])
                cache[r["matrix"]] = _widths(csr, BucketedELL.from_csr(csr))
            r["width"] = cache[r["matrix"]][r["path"][:3]]


def _coefs(rows) -> np.ndarray:
    """Non-negative least squares of ``gather_features`` in relative
    error over ``(path, record)`` rows of one path."""
    from scipy.optimize import nnls

    X = np.array([gather_features(p, r["work"], r["m"], r["k"], r["width"])
                  for p, r in rows])
    y = np.array([r["seconds"] for _, r in rows])
    return nnls(X / y[:, None], np.ones(len(y)))[0]


def _table(rows):
    """The H100 table with the model fit to ``(path, record)`` rows."""
    return dataclasses.replace(
        H100, gather_calib_records=tuple(
            (p, r["m"], r["work"], r["k"], r["seconds"], r["width"])
            for p, r in rows),
        gather_coefs=tuple(
            (path, tuple(_coefs([q for q in rows if q[0] == path])))
            for path in ("coo", "ell")))


def fit(records, route: str) -> dict:
    """The table's gather model over the route's records: per path the
    prior's coefficients, the prior's and the table's estimate over each
    record's time, and the table's with the record's matrix left out of
    both the prior's fit and the anchors (an estimate out of sample)."""
    rows = list(_route_rows(records, route))
    out = {}
    for path in ("coo", "ell"):
        mine = [(p, r) for p, r in rows if p == path]
        coefs = _coefs(mine)

        def ratio(table, r):
            return _calibrated_gather_seconds(
                path, r["work"], r["m"], r["k"], table,
                r["width"]) / r["seconds"]

        out[path] = {
            "coefs": [float(c) for c in coefs],
            "prior_ratio": [float(np.dot(coefs, gather_features(
                path, r["work"], r["m"], r["k"], r["width"])) / r["seconds"])
                for _, r in mine],
            "ratio": [ratio(_table(rows), r) for _, r in mine],
            "held_out_ratio": [ratio(_table(
                [q for q in rows if q[1]["matrix"] != r["matrix"]]), r)
                for _, r in mine],
            "records": [f'{r["matrix"]} k={r["k"]}' for _, r in mine]}
    return out


def render(path: str, route: str) -> str:
    """The source of ``formats/_gather_calib_h100.py`` from a card's
    ``gather_calib3.json`` (whose records carry ``width``)."""
    with open(path) as f:
        data = json.load(f)
    if data.get("device") != "cuda":
        raise ValueError(f"{path} is not a card's measurement")
    rows = [f'    ("{p}", {r["m"]}, {r["work"]}, {r["k"]}, '
            f'{r["seconds"]:.6e}, {r["width"]}),  # {r["matrix"]}'
            for p, r in _route_rows(data["records"], route)]
    rows.sort(key=lambda s: (s.split(",")[0], s))
    model = fit(data["records"], route)
    coefs = "\n".join(
        f'    ("{p}", (\n' + "".join(f"        {c!r},\n"
                                  for c in model[p]["coefs"]) + "    )),"
        for p in ("coo", "ell"))
    ell = "kernel B7" if route == "b7" else "the take route"
    return (f'"""The H100 gather-route calibration records: ``(path, m, work, '
            f'k,\nseconds)`` as the table of ``formats/cost.py::H100`` reads '
            f'them.\n\nWritten by ``exp_gather_calib3 --render`` (the port\'s '
            f'``scripts/``) from\n``results/h100/gather_calib3.json`` '
            f'({data["hardware"]}): '
            f'COO\nthrough ``spmm_coo``, bucketed ELL through {ell}, one '
            f'call timed\nwith CUDA events after its oracle check.\n"""\n\n'
            f'GATHER_CALIB_RECORDS_H100 = (\n' + "\n".join(rows) + "\n)\n\n"
            '#: The linear model the H100 table prices the gather routes '
            'with:\n#: ``ops/auto.py::gather_features``\' coefficients, fit '
            'to the\n#: records above.\n'
            f'GATHER_COEFS_H100 = (\n{coefs}\n)\n')


def main(argv=None) -> int:
    prog = "exp_gather_calib3"
    ap = _probe.parser(prog, __doc__)
    ap.add_argument("--matrices", nargs="+", default=list(FAMILIES),
                    choices=list(FAMILIES))
    ap.add_argument("--ks", type=int, nargs="+", default=list(KS))
    ap.add_argument("--render", metavar="JSON",
                    help="write formats/_gather_calib_h100.py from this "
                         "file and exit")
    args = ap.parse_args(argv)
    if args.render:
        route = "b7" if H100.spill_dma_gather else "take"
        with open(args.render) as f:
            data = json.load(f)
        add_widths(data)
        data["floors"] = floors(data["records"], route)
        data["fit"] = fit(data["records"], route)
        with open(args.render, "w") as f:
            json.dump(data, f, indent=1)
        with open(MODULE, "w") as f:
            f.write(render(args.render, route))
        print(f"wrote {MODULE}; floors {data['floors']}")
        for path in ("coo", "ell"):
            fit_ = data["fit"][path]
            print(f"{path}: estimate / measured " + ", ".join(
                f"{key} {min(fit_[key]):.2f}-{max(fit_[key]):.2f}"
                for key in ("prior_ratio", "ratio", "held_out_ratio")))
        return 0
    dev = _probe.device_of(prog, args)
    if isinstance(dev, int):
        return dev
    records = measure(args.matrices, args.ks, args.scale, dev)
    _probe.write(args, "gather_calib3", {"ks": args.ks, "records": records})
    return 0


if __name__ == "__main__":
    sys.exit(main())
