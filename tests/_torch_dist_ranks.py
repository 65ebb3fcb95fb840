"""Rank functions of the port's multi-rank tests.

``parallel/launch.py::run_ranks`` runs each in spawned processes, one
per rank (gloo on the CPU, NCCL on the card). This module imports no
JAX: the tests hold what the ranks return against the JAX package in
the parent process. Matrix recipes take the generator module and the
CSR class of either package, so both build the same matrix.
"""

import numpy as np
import torch

import sparsematrixmultiplicationmpi_tpu_torch.io.generate as TG
from sparsematrixmultiplicationmpi_tpu_torch.formats.matrix import CSR
from sparsematrixmultiplicationmpi_tpu_torch.ops import cuda_windowed
from sparsematrixmultiplicationmpi_tpu_torch.parallel import (
    Grid2D, get_strategy, make_mesh_2d,
)
from sparsematrixmultiplicationmpi_tpu_torch.parallel.windowed_strategy import (
    _halo_window, _rows,
)
from sparsematrixmultiplicationmpi_tpu_torch.utils import collectives as coll


def _skewed_dense(m, heavy_row, density, seed):
    """One near-dense row over light random rows (the power-law OOM
    class of the JAX package's skewed-tail tests)."""
    rng = np.random.default_rng(seed)
    dense = np.zeros((m, m))
    dense[heavy_row, :] = rng.normal(size=m)
    light = rng.uniform(size=(m, m)) < density
    return dense + np.where(light, rng.normal(size=(m, m)), 0.0)


def _band_plus_random(G, C):
    b, r = G.banded_csr(200, 5, 4, seed=103), G.random_csr(200, 200, 300,
                                                           seed=104)
    return C.from_dense(np.asarray(b.to_dense()) + np.asarray(r.to_dense()))


def _band_far_spill(G, C):
    """A 2048-row band with 200 entries 1024 columns off the diagonal."""
    csr = G.banded_csr(2048, 60, 8, seed=2)
    dense = np.asarray(csr.to_dense())
    rng = np.random.default_rng(3)
    rows = rng.integers(0, 2048, 200)
    np.add.at(dense, (rows, (rows + 1024) % 2048), rng.uniform(-1, 1, 200))
    return C.from_dense(dense)


#: name -> recipe(generate module, CSR class)
MATRICES = {
    "cage4_like": lambda G, C: G.cage4_like(),
    "random": lambda G, C: G.random_csr(100, 80, 900, seed=21),
    "banded": lambda G, C: G.banded_csr(120, 6, 5, seed=22),
    "powerlaw": lambda G, C: G.powerlaw_csr(90, 90, 1500, seed=23),
    "tall": lambda G, C: G.random_csr(200, 10, 400, seed=24),
    "wide": lambda G, C: G.random_csr(10, 200, 400, seed=25),
    "rows_odd": lambda G, C: G.random_csr(37, 29, 150, seed=26),
    "nnz_odd": lambda G, C: G.random_csr(50, 50, 331, seed=27),
    "skewed": lambda G, C: C.from_dense(_skewed_dense(64, 3, 0.05, 300)),
    "skewed48": lambda G, C: C.from_dense(_skewed_dense(48, 7, 0.08, 301)),
    "grid_random": lambda G, C: G.random_csr(96, 70, 800, seed=141),
    "auto_band": lambda G, C: G.banded_csr(2048, 20, 12, seed=310),
    "auto_scattered": lambda G, C: G.random_csr(4000, 4000, 24000,
                                                seed=311),
    "bf16_band": lambda G, C: G.banded_csr(96, 4, 3, seed=320),
    # windowed families (tests/test_windowed_strategy.py)
    "fem3000": lambda G, C: G.fem3d_csr(3000, 60000, seed=201),
    "fem2000": lambda G, C: G.fem3d_csr(2000, 40000, seed=203),
    "fem1500": lambda G, C: G.fem3d_csr(1500, 30000, seed=213),
    "powerlaw3000": lambda G, C: G.powerlaw_csr(3000, 3000, 30000,
                                                seed=207),
    "powerlaw2000": lambda G, C: G.powerlaw_csr(2000, 2000, 24000,
                                                seed=240),
    "banded2048": lambda G, C: G.banded_csr(2048, 40, 9, seed=209),
    "rect": lambda G, C: G.random_csr(1200, 2400, 20000, seed=242),
    # banded families (tests/test_banded_strategy.py)
    "pure_band": lambda G, C: G.banded_csr(256, 6, 5, seed=102),
    "band_spill": _band_plus_random,
    "band192": lambda G, C: G.banded_csr(192, 4, 3, seed=105),
    "band37": lambda G, C: G.banded_csr(37, 3, 2, seed=106),
    "cop20k_small": lambda G, C: G.cop20k_like(scale=0.02, seed=107),
    # collectives (tests/test_hlo_collectives.py)
    "band_hlo": lambda G, C: G.banded_csr(2048, 60, 8, seed=1),
    "band_hlo_spill": _band_far_spill,
    "random256": lambda G, C: G.random_csr(256, 256, 2000, seed=4),
    "random512": lambda G, C: G.random_csr(512, 512, 4000, seed=7),
    # the card tests
    "fem20k": lambda G, C: G.fem3d_csr(20000, 400000, seed=17),
    "spd_band": lambda G, C: G.banded_csr(4096, 200, 24, seed=18),
}


def build(name, G, C, dtype=None):
    """The named matrix by one package's generators; ``dtype`` a dtype
    of that package (None keeps float64)."""
    csr = MATRICES[name](G, C)
    return csr if dtype is None else csr.astype(dtype)


def case(id, matrix, strategy, k, *, kwargs=None, gather=True, seed=31,
         dtype=None, mesh2d=None, mode="spmm"):
    """One multiply for the ranks to run: ``mode`` is ``spmm``,
    ``chain1`` / ``chain2`` (``dec(body(enc(v)))`` with one or two
    bodies), ``permuted`` (``spmm_permuted`` on the encoded vector) or
    ``window`` (the rank's halo window of the encoded vector);
    ``dtype`` is None (float64), ``"float32"`` or ``"bfloat16"``."""
    return dict(id=id, matrix=matrix, strategy=strategy, k=k,
                kwargs=kwargs or {}, gather=gather, seed=seed, dtype=dtype,
                mesh2d=mesh2d, mode=mode)


def _torch_dtype(name):
    return None if name is None else getattr(torch, name)


def run_case(c, mesh, meshes2d=None):
    """One case on this rank: its output (its shard when not gathered),
    the whole result (``gather`` of the shard), the operand's type and
    input mode, and the collectives the multiply issued."""
    dt = _torch_dtype(c["dtype"])
    csr = build(c["matrix"], TG, CSR, dt)
    v = torch.from_numpy(TG.generate_fat_vector(csr.shape[1], c["k"],
                                                seed=c["seed"]))
    if dt is not None:
        v = v.to(dt)
    if c["mesh2d"] is not None:
        key = tuple(c["mesh2d"])
        if key not in meshes2d:
            meshes2d[key] = make_mesh_2d(*key, device=mesh.device.type)
        strategy, where = Grid2D(**c["kwargs"]), meshes2d[key]
    else:
        strategy, where = get_strategy(c["strategy"], **c["kwargs"]), mesh
    op = strategy.prepare(csr, where)
    v = v.to(mesh.device)
    gather = c["gather"]
    coll.reset_collective_stats()
    cuda_windowed.reset_launch_counts()
    if c["mode"] == "spmm":
        out = strategy.spmm(op, v, gather_result=gather)
    elif c["mode"] == "permuted":
        out = strategy.spmm_permuted(op, op.encode(v), gather_result=gather)
    elif c["mode"] == "window":
        d, s, C = mesh.rank, op.s_loc, op.chunk_cols
        out = _halo_window(_rows(op.encode(v), d * s, (d + 1) * s), mesh,
                           op.halo_left * C, op.halo_right * C)
    else:
        enc, body, dec = strategy.chain_parts(op, gather_result=gather)
        x = body(enc(v, op), op)
        if c["mode"] == "chain2":
            x = body(x, op)
        out = dec(x, op)
    stats = coll.collective_stats()
    launches = cuda_windowed.launch_counts()
    full = out
    if c["mode"] in ("spmm", "permuted") and not gather:
        full = strategy.gather(op, out, c["k"])
    elif c["mode"] == "permuted":
        full = op.decode(out)
    return {"out": out, "full": full, "stats": stats, "launches": launches,
            "operand": type(op).__name__,
            "input_mode": getattr(op, "input_mode", None),
            "tail": int(getattr(op, "tail_values", None).shape[0])
            if getattr(op, "tail_values", None) is not None else 0,
            "width": int(op.cols.shape[1]) if hasattr(op, "cols") else 0}


def run_cases(mesh, cases):
    """``{id: run_case(...)}`` for every case, in order (every rank runs
    the same cases, so their collectives pair up)."""
    meshes2d = {}
    return {c["id"]: run_case(c, mesh, meshes2d) for c in cases}


# ---- models over a mesh --------------------------------------------------

def gcn_steps(mesh, n, f, h, c, params, steps):
    """GCN on ``synthetic_node_classification(n, f, c, seed=330)`` in
    float64 over ``RowWise`` (the distributed symmetric SpMM): the first
    loss and gradients at ``params`` (numpy ``w1, b1, w2, b2``), then
    the losses of ``steps`` Adam(1e-2) steps and the parameters after
    them."""
    from sparsematrixmultiplicationmpi_tpu_torch.models import (
        gcn_loss, gcn_params_from_jax, make_train_step,
        normalize_adjacency, synthetic_node_classification,
    )
    from sparsematrixmultiplicationmpi_tpu_torch.ops.autodiff import (
        make_distributed_symmetric_spmm,
    )
    from sparsematrixmultiplicationmpi_tpu_torch.parallel import RowWise

    adj, x, labels, mask = synthetic_node_classification(
        n, f, c, seed=330, dtype=np.float64)
    row = RowWise()
    spmm = make_distributed_symmetric_spmm(
        row, row.prepare(normalize_adjacency(adj), mesh))
    x, labels, mask = (torch.from_numpy(a) for a in (x, labels, mask))
    p = gcn_params_from_jax(params, device=mesh.device)
    loss = gcn_loss(p, spmm, x, labels, mask)
    loss.backward()
    grads = [q.grad.clone() for q in p]
    step = make_train_step(spmm, torch.optim.Adam(p, lr=1e-2))
    losses = [step(p, x, labels, mask) for _ in range(steps)]
    return {"loss": loss.detach(), "grads": grads,
            "losses": torch.stack(losses),
            "params": [q.detach() for q in p]}


def _sym_banded(G, C, seed, spd):
    d = np.asarray(G.banded_csr(96, 3, 3, seed=seed).to_dense())
    a = d @ d.T + 8 * np.eye(96) if spd else d + d.T + 6 * np.eye(96)
    return C.from_dense(a)


def solvers(mesh):
    """CG (SPD banded system, ``BandedRowWise``), Lanczos (symmetric
    banded, ``BandedRowWise``), PageRank over ``RowWise`` and over the
    halo-mode ``WindowedRowWise``, each taking the distributed SpMM as
    its operator; ``comm_comp_split`` and a distributed
    ``run_benchmark``."""
    from sparsematrixmultiplicationmpi_tpu_torch.bench.harness import (
        run_benchmark,
    )
    from sparsematrixmultiplicationmpi_tpu_torch.models import (
        conjugate_gradient, normalize_columns, pagerank, topk_eigsh,
    )
    from sparsematrixmultiplicationmpi_tpu_torch.parallel import (
        BandedRowWise, RowWise, WindowedRowWise,
    )
    from sparsematrixmultiplicationmpi_tpu_torch.utils.profiling import (
        comm_comp_split,
    )

    dev = mesh.device
    out = {}
    band = BandedRowWise(block_rows=8)
    spd = _sym_banded(TG, CSR, 150, True)
    op = band.prepare(spd, mesh)
    b = torch.from_numpy(np.random.default_rng(151).normal(size=(96, 2)))
    res = conjugate_gradient(lambda x: band.spmm(op, x), b, tol=1e-12)
    out["cg_x"], out["cg_iters"] = res.x, int(res.iterations)

    sym = _sym_banded(TG, CSR, 331, False)
    op = band.prepare(sym, mesh)
    vals, _ = topk_eigsh(lambda x: band.spmm(op, x), 96, k=2, steps=60,
                         device=dev)
    out["eig"] = vals

    csr = TG.random_csr(60, 60, 500, seed=152)
    csr = type(csr)(values=np.abs(csr.values), col_indices=csr.col_indices,
                    row_ptr=csr.row_ptr, shape=csr.shape)
    row = RowWise()
    op = row.prepare(normalize_columns(csr), mesh)
    out["pagerank_row"], _ = pagerank(lambda x: row.spmm(op, x), 60,
                                      tol=1e-10, device=dev)

    win = WindowedRowWise(block_rows=32, chunk_cols=128)
    op = win.prepare(normalize_columns(TG.fem3d_csr(1500, 30000, seed=244)),
                     mesh)
    out["pagerank_windowed_mode"] = op.input_mode
    out["pagerank_windowed"], _ = pagerank(lambda x: win.spmm(op, x), 1500,
                                           tol=1e-8, device=dev)

    v = torch.from_numpy(TG.generate_fat_vector(60, 4, seed=5)).to(dev)
    op = row.prepare(normalize_columns(csr), mesh)
    out["comm_split"] = comm_comp_split(row, op, v, inner=4, iters=1)
    rec = run_benchmark(TG.fem3d_csr(1500, 30000, seed=244), 4, win, mesh,
                        gather_result=False, warmup=1, iters=1,
                        comm_split=True, inner=4)
    out["bench"] = {"correct": rec.correct, "devices": rec.devices,
                    "gathered": rec.gathered, "comp": rec.comp_time,
                    "comm": rec.comm_time}
    rec = run_benchmark(TG.fem3d_csr(1500, 30000, seed=244), 4, win, mesh,
                        gather_result=False, warmup=1, iters=1,
                        amortized=True, inner=4)
    out["bench_amortized_correct"] = rec.correct
    return out


def assemble(c, outs, p):
    """The ranks' ``out`` of case ``c`` laid out as the JAX package's
    global result: gathered results are whole on every rank (rank 0's);
    shards are concatenated by rows, by k-columns for ``ColumnWise``, as
    tiles for ``Grid2D``."""
    if c["gather"] or c["mode"] in ("chain1", "chain2"):
        return outs[0]
    if c["mesh2d"] is not None:
        a, b = c["mesh2d"]
        return np.concatenate([np.concatenate(outs[i * b:(i + 1) * b],
                                              axis=1) for i in range(a)])
    if c["strategy"] in ("column", "column_wise"):
        return np.concatenate(outs, axis=1)
    if c["strategy"] in ("nnz", "non_zero_element") and \
            c["kwargs"].get("reduce", "psum") == "psum":
        return outs[0]
    if c["strategy"] in ("library", "sequential"):
        return outs[0]
    return np.concatenate(outs)


def disagreeing_clocks(mesh):
    """``run_benchmark(amortized=True)`` on ranks whose clocks disagree:
    rank 0 finds its first chain's slope resolved, the others only their
    third (``measure_amortized`` wrapped). Returns how many chains this
    rank timed and whether the record is correct; the ranks must time
    the same number, or their collectives no longer pair up."""
    import dataclasses

    from sparsematrixmultiplicationmpi_tpu_torch.bench import harness

    real, calls = harness.measure_amortized, []

    def measure(fn, v, *args, **kwargs):
        timing, out = real(fn, v, *args, **kwargs)
        calls.append(kwargs.get("inner"))
        resolved = mesh.rank == 0 or len(calls) >= 3
        return dataclasses.replace(timing, resolved=resolved), out

    harness.measure_amortized = measure
    try:
        rec = harness.run_benchmark(
            TG.random_csr(64, 64, 400, seed=1), 4, get_strategy("row"),
            mesh, warmup=1, iters=1, amortized=True, inner=2)
    finally:
        harness.measure_amortized = real
    return len(calls), rec.correct
