"""Drift check of the H100 cost table: re-measure its constants on the
card and fail when one moved more than ``--tolerance`` (30 %).

    python -m sparsematrixmultiplicationmpi_tpu_torch.scripts.check_cost_constants

The port's counterpart of the JAX package's
``scripts/check_cost_constants.py``, against ``formats/cost.py::H100``:

* ``hbm_bw``: a 1 GiB device-to-device copy (bytes read and written
  over the time);
* ``gather_s_per_row`` and ``spill_restore_s_per_row``: the spill
  measurement of ``exp_spill_gather.py``;
* the windowed kernel's per-step, per-pair and per-entry costs, its
  slab stream rate and the CTAs that run at once: the measurement and
  fit of ``fit_probe17.py``.

Every time is taken with CUDA events after its result passed the f64
oracle. Writes ``cost_constants_check.json`` and exits 1 when any
constant is out of tolerance (the table, and the routing tests that pin
its picks, then need their probes run again).
"""

from __future__ import annotations

import sys

import torch

from ..formats.cost import H100
from . import _probe, exp_spill_gather, fit_probe17

#: The table's constants this check re-measures.
CHECKED = ("hbm_bw", "gather_s_per_row", "spill_restore_s_per_row",
           "tile_stream_bw", "entry_s", "ctas")


def copy_rate(dev, scale: float = 1.0) -> float:
    x = torch.ones(max(int(2 ** 28 * scale), 2 ** 20), device=dev)  # 1 GiB
    y = torch.empty_like(x)
    s = _probe.seconds(lambda: y.copy_(x), dev, n=10)
    if not torch.equal(x[:1024], y[:1024]):
        raise RuntimeError("the copy did not copy")
    return 2 * x.numel() * 4 / s


def measure(scale: float, dev) -> dict:
    got = {"hbm_bw": copy_rate(dev, scale)}
    got.update(exp_spill_gather.decide(exp_spill_gather.measure(scale, dev)))
    got.update(fit_probe17.fit(fit_probe17.measure(scale, dev))["constants"])
    return got


def compare(got: dict, tolerance: float) -> list:
    rows = []
    for name in CHECKED:
        stored = getattr(H100, name)
        ratio = got[name] / stored if stored else float("inf")
        rows.append({"constant": name, "measured": got[name],
                     "stored": stored, "ratio": ratio,
                     "ok": abs(ratio - 1) <= tolerance})
    return rows


def main(argv=None) -> int:
    prog = "check_cost_constants"
    ap = _probe.parser(prog, __doc__)
    ap.add_argument("--tolerance", type=float, default=0.30)
    args = ap.parse_args(argv)
    dev = _probe.device_of(prog, args)
    if isinstance(dev, int):
        return dev
    rows = compare(measure(args.scale, dev), args.tolerance)
    ok = all(r["ok"] for r in rows)
    for r in rows:
        print(f"{r['constant']}: measured {r['measured']:.6g}, stored "
              f"{r['stored']:.6g}, ratio {r['ratio']:.3f} "
              f"{'ok' if r['ok'] else 'DRIFT'}")
    _probe.write(args, "cost_constants_check", {
        "tolerance": args.tolerance, "constants": rows, "ok": ok})
    if not ok:
        print(f"{prog}: a constant moved more than {args.tolerance:.0%} "
              "from formats/cost.py::H100; run the probes again",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
