"""The port's main path on the CPU, held against the JAX package and the
host f64 oracle: ``Auto`` prepare + ``chain_parts`` (encode -> bodies ->
decode) on the identical operand, ``spmm_any`` on every format
``auto_format`` returns, and ``run_benchmark``. Results must agree within
the f32 tier (5e-3 relative to the largest output, or the harness's own
conditioned comparison).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sparsematrixmultiplicationmpi_tpu.formats.windowed as JW
import sparsematrixmultiplicationmpi_tpu.io.generate as JG
import sparsematrixmultiplicationmpi_tpu.ops.auto as JA
from sparsematrixmultiplicationmpi_tpu.parallel import Auto as JAuto
from sparsematrixmultiplicationmpi_tpu.parallel import make_mesh
import sparsematrixmultiplicationmpi_tpu_torch.formats.windowed as TW
import sparsematrixmultiplicationmpi_tpu_torch.io.generate as TG
import sparsematrixmultiplicationmpi_tpu_torch.ops.auto as TA
from sparsematrixmultiplicationmpi_tpu_torch.bench.harness import (
    HBM_BANDWIDTH, roofline_bytes, roofline_seconds, run_benchmark,
)
from sparsematrixmultiplicationmpi_tpu_torch.ops import cuda_windowed as cw
from sparsematrixmultiplicationmpi_tpu_torch.ops.oracle import spmm_host_f64
from sparsematrixmultiplicationmpi_tpu_torch.parallel import (
    Auto, Sequential, get_strategy,
)

CPU = torch.device("cpu")


def _rel(a, b):
    return float(np.abs(np.asarray(a, np.float64) - b).max()
                 / np.abs(b).max())


def _port_operand(jop):
    fields = {f.name: getattr(jop, f.name) for f in dataclasses.fields(jop)}
    return TW.WindowedPairs.from_arrays(**fields).to(CPU)


@pytest.mark.parametrize("kw,chain_rank", [
    (dict(block_rows=128, chunk_cols=128), 3),   # transposed-state chain
    ({}, 2),                                     # R != C: natural chain
], ids=["transposed", "natural"])
def test_auto_chain_matches_jax_chain_and_oracle(kw, chain_rank):
    k = 32
    csr = TG.cop20k_like(scale=0.03, dtype=np.float32)
    jop = JW.WindowedPairs.from_csr(
        JG.cop20k_like(scale=0.03, dtype=np.float32), **kw)
    op = _port_operand(jop)
    assert isinstance(op, TW.WindowedPairs) and op.perm is not None
    v = TG.generate_fat_vector(csr.shape[1], k, seed=1).astype(np.float32)

    enc, body, dec = Auto().chain_parts(op)
    jenc, jbody, jdec = JAuto().chain_parts(jop, make_mesh(1))
    state, jstate = enc(torch.from_numpy(v), op), jax.jit(jenc)(
        jnp.asarray(v), jop)
    assert state.dim() == jstate.ndim == chain_rank
    one = dec(body(state, op), op).numpy()
    assert _rel(one, spmm_host_f64(csr, v)) < 5e-3
    for _ in range(3):
        state, jstate = body(state, op), jax.jit(jbody)(jstate, jop)
    got, want = dec(state, op).numpy(), np.asarray(jax.jit(jdec)(jstate,
                                                                 jop))
    assert _rel(got, want) < 5e-3


def test_auto_prepare_routes_like_jax_and_lands_on_device():
    csr = TG.cop20k_like(scale=0.02, dtype=np.float32)
    op = Auto(k_nominal=32).prepare(csr, "cpu")
    jop = JA.auto_format(JG.cop20k_like(scale=0.02, dtype=np.float32),
                         k_nominal=32)
    assert type(op).__name__ == type(jop).__name__ == "WindowedPairs"
    assert (op.block_rows, op.chunk_cols, op.pairs_per_step) == \
        (jop.block_rows, jop.chunk_cols, jop.pairs_per_step)
    assert isinstance(op.tiles_t, torch.Tensor)
    assert op.tiles_t.dtype == torch.bfloat16 and op.device == CPU


@pytest.mark.parametrize("make,k", [
    (lambda g: g.banded_csr(6000, 40, 12, seed=15), 8),
    (lambda g: g.random_csr(5000, 5000, 40000, seed=16), 32),
    (lambda g: g.fem3d_csr(3000, 60000, seed=14), 6),
], ids=["banded", "bucketed-ell", "windowed"])
def test_spmm_any_matches_jax_on_each_format(make, k):
    csr = make(TG).astype(np.float32)
    jcsr = make(JG).astype(np.float32)
    op = TA.auto_format(csr, k_nominal=k)
    jop = JA.auto_format(jcsr, k_nominal=k)
    assert type(op).__name__ == type(jop).__name__
    v = TG.generate_fat_vector(csr.shape[1], k, seed=2).astype(np.float32)
    got = TA.spmm_any(op.to(CPU), torch.from_numpy(v)).numpy()
    want = np.asarray(JA.spmm_any(jop, jnp.asarray(v), use_pallas=False))
    ref = spmm_host_f64(csr, v)
    assert _rel(got, ref) < 5e-3
    assert _rel(got, want) < 5e-3


def test_spmm_any_on_coo_and_sequential_strategy():
    csr = TG.powerlaw_csr(800, 800, 8000, seed=3, dtype=np.float32)
    v = TG.generate_fat_vector(800, 4, seed=4).astype(np.float32)
    ref = spmm_host_f64(csr, v)
    got = TA.spmm_any(csr.to_coo().to(CPU), torch.from_numpy(v)).numpy()
    assert _rel(got, ref) < 5e-3
    seq = Sequential()
    out = seq.spmm(seq.prepare(csr, "cpu"), torch.from_numpy(v)).numpy()
    assert _rel(out, ref) < 5e-3


def test_unported_accelerator_routes_raise():
    # A band on a device that is neither CPU nor CUDA has no route: it
    # raises rather than taking the plain path quietly.
    band = TA.auto_format(TG.banded_csr(6000, 40, 12, seed=15).astype(
        np.float32), k_nominal=8)
    assert band.block_rows <= 128
    meta_v = torch.empty((6000, 8), device="meta")
    with pytest.raises(ValueError, match="no band route for a tensor on meta"):
        TA.spmm_any(band.to("meta"), meta_v)
    u2 = TW.WindowedPairs.from_csr(
        TG.fem3d_csr(1024, 16000, seed=8).astype(np.float32),
        pairs_per_step=2, beat_gather_margin=1e9)
    # A U=2 operand on such a device routes to its kernels (B2 + B3),
    # which take only CUDA tensors.
    meta_v = torch.empty((1024, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel for a tensor on meta"):
        TA.spmm_any(u2.to("meta"), meta_v)
    # Every strategy of the JAX package is ported now (row_wise
    # included); a name outside the table still raises.
    assert type(get_strategy("row_wise")).__name__ == "RowWise"
    with pytest.raises(ValueError, match="unknown strategy"):
        get_strategy("bogus")


@pytest.mark.parametrize("amortized", [True, False])
def test_run_benchmark_on_cpu(amortized):
    csr = TG.cop20k_like(scale=0.02, dtype=np.float32)
    cw.reset_launch_counts()
    rec = run_benchmark(csr, 32, Auto(block_rows=128, chunk_cols=128),
                        "cpu", matrix_name="cop20k_like", warmup=1, iters=2,
                        amortized=amortized, inner=3)
    assert rec.correct is True
    assert rec.device_kind == "cpu" and rec.devices == 1
    assert rec.nnz == csr.nnz and rec.dtype == "float32"
    assert (rec.time_upper_bound is not None) == amortized
    assert rec.prepare_time > 0
    if rec.execution_time == rec.execution_time:
        assert rec.gnnz_per_s == pytest.approx(
            csr.nnz / rec.execution_time / 1e9)
    assert cw.launch_counts() == dict.fromkeys(
        ("B1", "B2", "B3", "B4", "B6"), 0)


def test_roofline_model_and_bandwidth_table():
    assert roofline_bytes(10, 5, 5, 2) == 10 * 8 + 10 * 2 * 4 + 5 * 2 * 4
    sxm = roofline_seconds(10 ** 6, 10 ** 5, 10 ** 5, 32,
                           kind="NVIDIA H100 80GB HBM3")
    assert sxm == pytest.approx(roofline_bytes(10 ** 6, 10 ** 5, 10 ** 5,
                                               32) / 3.35e12)
    cpu = roofline_seconds(10 ** 6, 10 ** 5, 10 ** 5, 32, kind="cpu")
    assert cpu == pytest.approx(sxm * 3.35e12 / HBM_BANDWIDTH["cpu"])
    # A card without a data-sheet figure on record has no roofline.
    for kind in ("NVIDIA H100 PCIe", "NVIDIA A100-SXM4-80GB"):
        with pytest.raises(ValueError, match="no memory bandwidth"):
            roofline_seconds(10 ** 6, 10 ** 5, 10 ** 5, 32, kind=kind)


def test_auto_chain_builds_each_width_once(monkeypatch):
    import sparsematrixmultiplicationmpi_tpu_torch.ops.windowed as TOW

    built = []
    real = TOW.windowed_t_chain
    monkeypatch.setattr(TOW, "windowed_t_chain",
                        lambda wp, k: built.append(k) or real(wp, k))
    csr = TG.cop20k_like(scale=0.02, dtype=np.float32)
    op = Auto(block_rows=128, chunk_cols=128).prepare(csr, "cpu")
    enc, body, dec = Auto().chain_parts(op)
    v = TG.generate_fat_vector(csr.shape[1], 32, seed=5).astype(np.float32)
    state = enc(torch.from_numpy(v), op)
    assert state.dim() == 3
    for _ in range(3):
        state = body(state, op)
    out = dec(state, op).numpy()
    assert built == [32]
    assert np.isfinite(out).all() and out.shape == (csr.shape[0], 32)
