"""The card's narrow-k gate: the windowed kernels on slabs padded to a
multiple of 8 against the plain route, at k in (1, 3, 6, 9, 12).

    python -m sparsematrixmultiplicationmpi_tpu_torch.scripts.exp_kpad_windowed

The port's counterpart of the JAX package's ``scripts/exp_kpad_windowed.py``.
On the cop20k stand-in's U = 16 operand (B2 + B1), its U = 2 f32 operand
(B2 + B3, the spill by the table's route) and its U = 2 bf16 operand
(B2 + B4), each width is timed with CUDA events through
``spmm_windowed_core`` on the kernels' route (``k`` zero-padded to k8)
and on the plain route (``spmm_windowed_xla``), after both passed the f64
oracle, and the kernel alone at k8. ``kpad_min_k`` is the smallest k
from which the padded kernels win at every measured k (the reference
measured 12 on the v5e). Writes ``kpad_windowed.json``.
"""

from __future__ import annotations

import sys

import torch

from ..formats.cost import V5E
from ..formats.matrix import cast
from ..ops import cuda_windowed as cw
from ..ops.auto import auto_format
from ..ops.windowed import spmm_windowed_core, spmm_windowed_xla
from . import _probe
from .fit_probe17 import kernel_fn

KS = (1, 3, 6, 9, 12)
#: (label, auto_format arguments, dtype): the reference's picks on the
#: cop20k stand-in, as chip_smoke.py's phases drive them.
OPERANDS = (("u16_f32", {}, torch.float32),
            ("u2_f32", {"pairs_per_step": 2}, torch.float32),
            ("u2_bf16", {"pairs_per_step": 2}, torch.bfloat16))


def _kernel(wp, slabs):
    if wp.pairs_per_step <= 2 and not wp.split:
        return lambda: cw.windowed_matmul_single(
            wp.pair_block, wp.pair_chunk, wp.block_ptr, wp.natural_plane,
            slabs, nb=wp.n_blocks)
    return kernel_fn(wp, slabs)


def measure(scale: float, dev, ks=KS) -> list:
    csr = _probe.matrix("cop20k_like", scale)
    rows = []
    for label, kwargs, dtype in OPERANDS:
        mat = csr.astype(dtype)
        # The reference's operand, as chip_smoke drives it.
        host = auto_format(mat, cost_table=V5E, **kwargs)
        wp = host.to(dev)
        for k in ks:
            v_host, v = _probe.fat_vector(csr.shape[1], k, dev)
            v_host = cast(v_host, dtype)
            check = _probe.Checked(mat, v_host)
            v = v.to(dtype)
            v_p = wp.encode(v).contiguous()
            k8 = -(-k // 8) * 8
            times = {}
            for route, fn in (("kernels", spmm_windowed_core),
                              ("plain", spmm_windowed_xla)):
                def call(fn=fn):
                    return fn(wp, v_p)

                if not check.ok(wp.decode(call()), dtype):
                    raise RuntimeError(f"{label} k={k} {route}: disagrees "
                                       "with spmm_host_f64")
                times[route] = _probe.seconds(call, dev, n=10)
            v8 = torch.cat([v_p, v_p.new_zeros((v_p.shape[0], k8 - k))],
                           dim=1) if k8 != k else v_p
            slab_dtype = torch.float32 if wp.split else wp.dtype
            slabs = cw.chunk_slabs(v8.to(slab_dtype).contiguous(),
                                   C=wp.chunk_cols, split=wp.split)
            kern = _probe.seconds(_kernel(wp, slabs), dev)
            rows.append({"operand": label, "k": k, "k8": k8,
                         "kernels_s": times["kernels"],
                         "plain_s": times["plain"], "kernel_alone_s": kern,
                         "R": wp.block_rows, "C": wp.chunk_cols,
                         "U": wp.pairs_per_step})
            print(f"{label} k={k}: kernels {times['kernels'] * 1e3:.4f} ms,"
                  f" plain {times['plain'] * 1e3:.4f} ms, kernel alone at "
                  f"k8={k8} {kern * 1e3:.4f} ms", flush=True)
        del wp, host
    return rows


def decide(rows) -> int:
    """The smallest k from which the kernels win at every measured k."""
    ks = sorted({r["k"] for r in rows})
    wins = {k: all(r["kernels_s"] < r["plain_s"] for r in rows
                   if r["k"] == k) for k in ks}
    best = max(ks) + 1
    for k in reversed(ks):
        if not wins[k]:
            break
        best = k
    return 1 if best == min(ks) else best


def main(argv=None) -> int:
    prog = "exp_kpad_windowed"
    ap = _probe.parser(prog, __doc__)
    ap.add_argument("--ks", type=int, nargs="+", default=list(KS))
    args = ap.parse_args(argv)
    dev = _probe.device_of(prog, args)
    if isinstance(dev, int):
        return dev
    rows = measure(args.scale, dev, args.ks)
    kpad = decide(rows)
    print(f"kpad_min_k {kpad}")
    _probe.write(args, "kpad_windowed", {"rows": rows, "kpad_min_k": kpad})
    return 0


if __name__ == "__main__":
    sys.exit(main())
