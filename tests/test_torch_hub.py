"""The port's hub-column extraction (``formats/hub.py``, the
``allow_hub`` candidate of ``ops/auto.py``) against the JAX package's.

Tolerances: the host builders (``split_hub_columns``, the hub pick) are
numpy on both sides and must agree bit for bit. ``spmm_any`` on a
``HubExtracted`` sums the same products in another order: float64 within
1e-10 relative to the largest output, f32 within 1e-5 relative plus
1e-6 times the conditioning ``sum |a_ij v_jk|``; bf16 within 5e-2 of the
f64 oracle, as the JAX package's own test holds it.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sparsematrixmultiplicationmpi_tpu.io.generate as JG
import sparsematrixmultiplicationmpi_tpu.ops.auto as JA
from sparsematrixmultiplicationmpi_tpu.formats.hub import (
    split_hub_columns as j_split_hub_columns,
)
import sparsematrixmultiplicationmpi_tpu_torch.io.generate as TG
import sparsematrixmultiplicationmpi_tpu_torch.ops.auto as TA
from sparsematrixmultiplicationmpi_tpu_torch.formats.hub import (
    MAX_HUB_COLS, HubExtracted, split_hub_columns,
)
from sparsematrixmultiplicationmpi_tpu_torch.formats.matrix import BucketedELL
from sparsematrixmultiplicationmpi_tpu_torch.ops.oracle import spmm_host_f64

CPU = torch.device("cpu")

#: The families of the JAX package's tests/test_hub.py, plus a larger
#: dc1 and a power-law graph.
FAMILIES = {
    "dc1": lambda g: g.dc1_like(scale=0.02),
    "dc1_large": lambda g: g.dc1_like(scale=0.05),
    "uniform": lambda g: g.random_csr(2000, 2000, 20000, seed=5),
    "random_small": lambda g: g.random_csr(500, 500, 3000, seed=1),
    "powerlaw": lambda g: g.powerlaw_csr(3000, 3000, 30000, seed=3),
}

#: The hub pick is also held at dc1's full size (116,835 rows), where
#: the card's smoke runs it: 4 hubs over a BucketedELL remainder.
PICK_FAMILIES = {**FAMILIES, "dc1_full": lambda g: g.dc1_like()}


def _both(make, dtype=np.float32):
    return make(JG).astype(dtype), make(TG).astype(dtype)


def _same_csr(j, t):
    assert j.shape == t.shape
    for f in ("values", "col_indices", "row_ptr"):
        a, b = np.asarray(getattr(j, f)), getattr(t, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def _thresholds(csr):
    counts = np.bincount(np.asarray(csr.col_indices), minlength=csr.shape[1])
    top = int(counts.max())
    return [top, top // 2 or 1, 2]


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("which", [0, 1, 2])
def test_split_hub_columns_matches_jax_bitwise(family, which):
    jc, tc = _both(FAMILIES[family])
    thr = _thresholds(tc)[which]
    for max_cols in (MAX_HUB_COLS, 3):
        js = j_split_hub_columns(jc, threshold=thr, max_cols=max_cols)
        ts = split_hub_columns(tc, threshold=thr, max_cols=max_cols)
        assert (js is None) == (ts is None)
        if ts is None:
            continue
        (jids, jdense, jrem), (ids, dense, rem) = js, ts
        assert ids.dtype == np.int32 and len(ids) <= max_cols
        np.testing.assert_array_equal(ids, np.asarray(jids))
        assert dense.dtype == np.asarray(jdense).dtype
        np.testing.assert_array_equal(dense, np.asarray(jdense))
        _same_csr(jrem, rem)
        # extracted + remainder is the matrix
        full = rem.to_dense()
        full[:, ids] += dense
        np.testing.assert_array_equal(full, tc.to_dense())


def test_split_returns_none_without_hubs():
    _, tc = _both(FAMILIES["random_small"])
    assert split_hub_columns(tc, threshold=400) is None


@pytest.mark.parametrize("family", sorted(PICK_FAMILIES))
def test_auto_format_allow_hub_picks_like_jax(family):
    jc, tc = _both(PICK_FAMILIES[family])
    jop = JA.auto_format(jc, allow_hub=True)
    op = TA.auto_format(tc, allow_hub=True)
    assert type(op).__name__ == type(jop).__name__
    assert op.est_seconds == jop.est_seconds
    if isinstance(op, HubExtracted):
        assert op.shape == jop.shape and 1 <= op.n_hubs <= MAX_HUB_COLS
        np.testing.assert_array_equal(op.hub_ids, np.asarray(jop.hub_ids))
        np.testing.assert_array_equal(op.dense_cols,
                                      np.asarray(jop.dense_cols))
        rem, jrem = op.remainder, jop.remainder
        assert type(rem).__name__ == type(jrem).__name__
        assert (getattr(rem, "est_seconds", None)
                == getattr(jrem, "est_seconds", None))
        if isinstance(rem, BucketedELL):
            for b, jb in zip(rem.buckets, jrem.buckets, strict=True):
                np.testing.assert_array_equal(b.cols, np.asarray(jb.cols))
                np.testing.assert_array_equal(b.vals, np.asarray(jb.vals))
            np.testing.assert_array_equal(rem.row_perm,
                                          np.asarray(jrem.row_perm))
        if type(rem).__name__ == "WindowedPairs":
            assert (rem.block_rows, rem.chunk_cols, rem.pairs_per_step) == (
                jrem.block_rows, jrem.chunk_cols, jrem.pairs_per_step)
            np.testing.assert_array_equal(rem.pair_block,
                                          np.asarray(jrem.pair_block))
    if family == "dc1_full":
        assert (op.n_hubs, type(op.remainder).__name__) == (4, "BucketedELL")
    # allow_hub is opt-in, as in the JAX package
    assert not isinstance(TA.auto_format(tc), HubExtracted)


def _hub(dtype=np.float32, scale=0.02):
    jc = JG.dc1_like(scale=scale).astype(dtype)
    tc = TG.dc1_like(scale=scale).astype(dtype)
    jop, op = JA.auto_format(jc, allow_hub=True), TA.auto_format(
        tc, allow_hub=True)
    assert isinstance(op, HubExtracted)
    return jc, tc, jop, op


@pytest.mark.parametrize("k", [1, 8, 32])
def test_spmm_any_on_hub_matches_jax_f64(k):
    _, tc, jop, op = _hub(np.float64)
    v = TG.generate_fat_vector(tc.shape[1], k, seed=k)
    got = TA.spmm_any(op.to(CPU), torch.from_numpy(v)).numpy()
    want = np.asarray(JA.spmm_any(jop, jnp.asarray(v)))
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10 * scale)
    np.testing.assert_allclose(got, spmm_host_f64(tc, v), rtol=0,
                               atol=1e-10 * scale)


@pytest.mark.parametrize("k", [4, 32])
def test_spmm_any_on_hub_matches_jax_f32(k):
    _, tc, jop, op = _hub(np.float32)
    v = TG.generate_fat_vector(tc.shape[1], k, seed=k).astype(np.float32)
    got = TA.spmm_any(op.to(CPU), torch.from_numpy(v)).double().numpy()
    want = np.asarray(JA.spmm_any(jop, jnp.asarray(v)), np.float64)
    abs_csr = dataclasses.replace(tc, values=np.abs(tc.values))
    cond = spmm_host_f64(abs_csr, np.abs(v))
    assert np.all(np.abs(got - want) <= 1e-5 * np.abs(want) + 1e-6 * cond)
    assert np.all(np.abs(got - spmm_host_f64(tc, v))
                  <= 1e-5 * np.abs(want) + 1e-6 * cond)


def test_hub_astype_bf16_and_matmul():
    _, tc, _, op = _hub(np.float32)
    opb = op.astype(torch.bfloat16).to(CPU)
    assert opb.dense_cols.dtype == torch.bfloat16
    v = TG.generate_fat_vector(tc.shape[1], 4, seed=4).astype(np.float32)
    out = (opb @ torch.from_numpy(v).to(torch.bfloat16)).double().numpy()
    ref = spmm_host_f64(tc, v)
    assert np.abs(out - ref).max() / np.abs(ref).max() < 5e-2


def test_hub_to_keeps_host_arrays_and_to_dense():
    _, tc, _, op = _hub(np.float64)
    moved = op.to(CPU)
    assert isinstance(moved.dense_cols, torch.Tensor)
    assert moved.hub_ids.dtype == torch.int32
    assert isinstance(op.dense_cols, np.ndarray)
    assert op.n_hubs == moved.n_hubs == op.dense_cols.shape[1]
    ids, dense, rem = split_hub_columns(tc, threshold=64)
    hub = HubExtracted(dense_cols=dense, hub_ids=ids,
                       remainder=BucketedELL.from_csr(rem), shape=tc.shape)
    np.testing.assert_array_equal(hub.to_dense(), tc.to_dense())
