"""The flagship model's forward step and the multi-rank dryrun (the
analogs of the JAX package's ``__graft_entry__.py::entry`` and
``dryrun_multichip``).

    from sparsematrixmultiplicationmpi_tpu_torch.entry import entry
    forward, args = entry()          # on the card; entry("cpu") on the CPU
    logits = forward(*args)

    dryrun_multichip(n)              # n ranks, one card each (NCCL)
    dryrun_multichip(4, device="cpu")  # 4 ranks on the CPU (gloo)
"""

from __future__ import annotations

import numpy as np
import torch

from .models.gcn import (
    gcn_forward, init_gcn, normalize_adjacency,
    synthetic_node_classification,
)
from .ops.auto import auto_format
from .ops.autodiff import make_symmetric_spmm

__all__ = ["entry", "dryrun_multichip"]


def entry(device="cuda"):
    """``(forward, (params, operand, x))`` for a 256-node graph (32
    features, 64 hidden, 4 classes, f32) on ``device``."""
    n, n_features, hidden, n_classes = 256, 32, 64, 4
    adj, x, _, _ = synthetic_node_classification(
        n, n_features, n_classes, seed=0, dtype=np.float32)
    # The cast goes through the format's astype, which re-derives every
    # plane the kernels read; a leaf-by-leaf cast would not.
    operand = auto_format(normalize_adjacency(adj)).astype(
        torch.float32).to(device)
    params = init_gcn(n_features, hidden, n_classes,
                      generator=torch.Generator().manual_seed(0),
                      dtype=torch.float32, device=device)

    def forward(params, operand, x):
        return gcn_forward(params, make_symmetric_spmm(operand), x)

    return forward, (params, operand, torch.from_numpy(x).to(device))


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"dryrun_multichip: {msg}")


def _max_err(out, want) -> float:
    return float(np.max(np.abs(out.detach().cpu().double().numpy() - want)))


def _dryrun_rank(mesh) -> dict:
    """One rank of ``dryrun_multichip``: returns its GCN loss, the largest
    parameter difference from the one-device step and across ranks, and
    each strategy's max abs error against a dense product (each is
    checked too)."""
    from .formats.windowed import WindowedPairs
    from .io.generate import (
        banded_csr, fem3d_csr, generate_fat_vector, powerlaw_csr,
    )
    from .models.gcn import make_train_step
    from .ops.autodiff import make_distributed_symmetric_spmm
    from .ops.windowed import windowed_t_chain
    from .parallel import (
        Auto, BandedRowWise, ColumnWise, Grid2D, Library, NonZeroElement,
        RowWise, WindowedRowWise, make_mesh_2d,
    )
    from .utils import collectives as coll

    p, dev = mesh.size, mesh.device
    f32 = np.float32
    report = {"rank": mesh.rank, "errors": {}}

    # 1. One GCN training step over the row-sharded adjacency, against
    # the same step through the one-device operand.
    n, n_features, hidden, n_classes = 8 * p * 2, 8, 16, 3
    adj, x, labels, mask = synthetic_node_classification(
        n, n_features, n_classes, seed=1, dtype=f32)
    a_hat = normalize_adjacency(adj).astype(f32)
    row = RowWise()
    x, labels, mask = (torch.from_numpy(a).to(dev)
                       for a in (x, labels, mask))
    losses, trained = [], []
    for spmm in (make_distributed_symmetric_spmm(row, row.prepare(
            a_hat, mesh)), make_symmetric_spmm(auto_format(a_hat).to(dev))):
        params = init_gcn(n_features, hidden, n_classes,
                          generator=torch.Generator().manual_seed(0),
                          dtype=torch.float32, device=dev)
        step = make_train_step(spmm, torch.optim.Adam(params, lr=1e-2))
        losses.append(float(step(params, x, labels, mask)))
        trained.append(torch.cat([q.detach().reshape(-1) for q in params]))
    _require(np.isfinite(losses[0]), "the training step's loss is not finite")
    _require(abs(losses[0] - losses[1]) <= 1e-5 * abs(losses[1]),
             f"distributed and one-device losses differ: {losses}")
    report["gcn_loss"] = losses[0]
    report["gcn_param_diff"] = float((trained[0] - trained[1]).abs().max())
    across = coll.all_gather(trained[0][None], mesh)
    report["gcn_param_spread"] = float((across - across[0]).abs().max())
    _require(report["gcn_param_diff"] <= 1e-5 and
             report["gcn_param_spread"] == 0.0,
             f"parameters after the step differ: {report}")

    def check(label, strategy, operand, v, want, gather, tol):
        out = strategy.spmm(operand, v, gather_result=gather)
        if not gather:
            out = strategy.gather(operand, out, v.shape[1])
        err = _max_err(out, want) / max(float(np.abs(want).max()), 1.0)
        report["errors"][label] = err
        _require(err < tol, f"{label}: rel err={err}")

    # 2. Every distributed strategy against a dense product.
    csr = powerlaw_csr(16 * p, 16 * p, 64 * p, seed=2).astype(f32)
    v_host = generate_fat_vector(csr.shape[1], 2 * p, seed=3).astype(f32)
    v = torch.from_numpy(v_host).to(dev)
    dense = csr.to_dense().astype(np.float64) @ v_host
    for strategy, gather in ((RowWise(), True), (RowWise(), False),
                             (ColumnWise(), True), (ColumnWise(), False),
                             (NonZeroElement(reduce="psum"), True),
                             (NonZeroElement(reduce="scatter"), False),
                             (Library(), True)):
        check(f"{strategy.name}-{getattr(strategy, 'reduce', '')}-"
              f"{gather}", strategy, strategy.prepare(csr, mesh), v, dense,
              gather, 1e-2)

    # 2b. The 2-D (rows x k) mesh and the mesh-routed Auto.
    if p >= 4 and p % 2 == 0:
        mesh2 = make_mesh_2d(p // 2, 2, device=dev.type)
        g = Grid2D()
        check("grid2d", g, g.prepare(csr, mesh2), v, dense, True, 1e-2)
        auto = Auto()
        check("auto", auto, auto.prepare(csr, mesh), v, dense, True, 1e-2)

    # 2c. The windowed row strategy through its per-rank kernels on the
    # card (U = 2: B2 + B3; U = 16 with R = 128: B2 + B1; k = 12 takes
    # the k-pad route), the plain versions on the CPU.
    wcsr = fem3d_csr(64 * p, 1024 * p, seed=6).astype(f32)
    for u, kw, r in ((2, 8, 16), (8, 8, 16), (2, 12, 16), (16, 8, 128)):
        vw = generate_fat_vector(wcsr.shape[1], kw, seed=7).astype(f32)
        strat = WindowedRowWise(block_rows=r, chunk_cols=128,
                                pairs_per_step=u)
        check(f"windowed_row-U{u}-k{kw}-R{r}", strat,
              strat.prepare(wcsr, mesh), torch.from_numpy(vw).to(dev),
              wcsr.to_dense().astype(np.float64) @ vw, True, 1e-3)

    # 2d. The one-device transposed chain (B2, B1 with the fused state).
    tcsr = banded_csr(64 * p, 24, 8, seed=8).astype(f32)
    wp = WindowedPairs.from_csr(tcsr, block_rows=128, chunk_cols=128,
                                reorder=None, pairs_per_step=8,
                                beat_gather_margin=1e9, max_inflation=1e9)
    _require(wp is not None and wp.supports_transposed_chain,
             "the banded operand does not take the transposed chain")
    wp = wp.to(dev)
    enc, body, dec = windowed_t_chain(wp, 8)
    vt = generate_fat_vector(tcsr.shape[1], 8, seed=9).astype(f32)
    out = dec(body(enc(torch.from_numpy(vt).to(dev), wp), wp), wp)
    want = tcsr.to_dense().astype(np.float64) @ vt
    err = _max_err(out, want) / max(float(np.abs(want).max()), 1.0)
    report["errors"]["transposed_chain"] = err
    _require(err < 1e-2, f"transposed chain: rel err={err}")

    # 3. The halo-exchange band strategy.
    bcsr = banded_csr(32 * p, 5, 4, seed=4).astype(f32)
    vb = generate_fat_vector(bcsr.shape[1], 3, seed=5).astype(f32)
    for gather in (True, False):
        strat = BandedRowWise(block_rows=8)
        check(f"banded_row-{gather}", strat, strat.prepare(bcsr, mesh),
              torch.from_numpy(vb).to(dev),
              bcsr.to_dense().astype(np.float64) @ vb, gather, 1e-2)
    return report


def dryrun_multichip(n_devices: int, *, device="cuda") -> list:
    """The multi-rank dryrun: ``n_devices`` spawned ranks (one card each
    with NCCL; gloo on the CPU when ``device="cpu"``) each run one GCN
    training step over ``RowWise`` (loss and updated parameters equal to
    the one-device step's, and equal across ranks) and every
    distributed strategy against a dense product. Fewer cards than ranks
    raises (the JAX dryrun falls back to CPU devices; this one never
    leaves the card unasked). Returns each rank's report."""
    from .parallel.launch import run_ranks

    if torch.device(device).type == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n_devices:
            raise ValueError(f"need {n_devices} devices, have {have}")
    return run_ranks(_dryrun_rank, n_devices, device=device)
