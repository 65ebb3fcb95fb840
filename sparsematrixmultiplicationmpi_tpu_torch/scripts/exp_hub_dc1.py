"""The card's hub price: the hub route on the dc1 circuit class against
its remainder alone and against the no-hub pick.

    python -m sparsematrixmultiplicationmpi_tpu_torch.scripts.exp_hub_dc1

The port's counterpart of the JAX package's ``scripts/exp_hub_dc1.py``.
``dc1_like`` (the results sweep's) is split into its hub columns at the
reference's threshold (``m * 4 / hbm_bw / ell_s_per_slot`` of the v5e
table, which picks 4 hubs there), the remainder formatted as
``auto_format`` formats it for the card. At k in (6, 32) the hub route
(``spmm_any`` of the ``HubExtracted``), the remainder alone and the
card's no-hub pick of the whole matrix are checked against the f64
oracle (the remainder against its own) and timed with CUDA events.
``hub_s`` is the median over k of what the hub route adds to its
remainder beyond ``(m h + h k) * 4 / hbm_bw``, the part the reference's
price already counts. Writes ``hub_dc1.json``.
"""

from __future__ import annotations

import sys

import numpy as np

from ..formats.cost import V5E, cost_table_for
from ..formats.hub import HubExtracted, split_hub_columns
from ..ops.auto import auto_format, spmm_any
from . import _probe

KS = (6, 32)


def measure(scale: float, dev) -> dict:
    table = cost_table_for(dev)
    csr = _probe.matrix("dc1_like", scale)
    m, n = csr.shape
    threshold = max(int(m * 4 / V5E.hbm_bw / V5E.ell_s_per_slot), 32)
    split = split_hub_columns(csr, threshold=threshold)
    if split is None:
        raise RuntimeError("dc1_like has no hub column at this size")
    hub_ids, dense_cols, rem = split
    h = len(hub_ids)
    out = {"m": m, "nnz": csr.nnz, "hubs": h, "threshold": threshold,
           "table": table.name, "ks": {}}
    rem_host = auto_format(rem, device=dev)
    base_host = auto_format(csr, device=dev)
    hub = HubExtracted(dense_cols=dense_cols, hub_ids=hub_ids,
                       remainder=rem_host, shape=csr.shape,
                       est_seconds=float("nan")).to(dev)
    rem_op, base_op = rem_host.to(dev), base_host.to(dev)
    out["remainder_format"] = type(rem_host).__name__
    out["no_hub_format"] = type(base_host).__name__
    extra = []
    for k in KS:
        v_host, v = _probe.fat_vector(n, k, dev)
        check = _probe.Checked(csr, v_host)
        rem_check = _probe.Checked(rem, v_host)
        row = {
            "hub_s": _probe.timed_checked(
                f"hub k={k}", lambda: spmm_any(hub, v), check, dev),
            "remainder_s": _probe.timed_checked(
                f"remainder k={k}", lambda: spmm_any(rem_op, v), rem_check,
                dev),
            "no_hub_s": _probe.timed_checked(
                f"no hub k={k}", lambda: spmm_any(base_op, v), check, dev)}
        out["ks"][str(k)] = row
        extra.append(row["hub_s"] - row["remainder_s"]
                     - (m * h + h * k) * 4 / table.hbm_bw)
        print(f"k={k}: " + ", ".join(f"{key} {val * 1e3:.4f} ms"
                                     for key, val in row.items()),
              flush=True)
    out["hub_s"] = max(float(np.median(extra)), 0.0)
    return out


def main(argv=None) -> int:
    prog = "exp_hub_dc1"
    ap = _probe.parser(prog, __doc__)
    args = ap.parse_args(argv)
    dev = _probe.device_of(prog, args)
    if isinstance(dev, int):
        return dev
    out = measure(args.scale, dev)
    print(f"hub_s {out['hub_s']}")
    _probe.write(args, "hub_dc1", out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
