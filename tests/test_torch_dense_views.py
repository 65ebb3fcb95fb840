"""Dense views and dtypes of every format against the JAX package's, on
the CPU: ``to_dense``, ``ops/oracle.py::spmm_dense``, ``dense_bytes``
and ``.dtype`` of CSR, COO, ELL, BucketedELL, WindowedPairs and
HubExtracted, in f32 and bf16, built from the same seeded numpy input by
either package.

Tolerances: a dense view is host numpy in both packages and must match
bit for bit, the JAX package's bf16 values read as float32 (the port's
dense view of a bf16 operand is float32 holding its bf16 values
exactly). ``spmm_dense`` sums the same products in another order: within
``utils/compare.py::default_tolerance`` of ``v``'s dtype, relative. A
copy whose arrays are tensors (``.to("cpu")``, as a card copy is) gives
the host operand's view bit for bit; a windowed copy that holds only the
card's planes (``card_planes``) too, except where those are split bf16
hi|lo planes of f32 tiles: their hi + lo is within 2**-16 of each value.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sparsematrixmultiplicationmpi_tpu.formats as JF
import sparsematrixmultiplicationmpi_tpu.formats.windowed as JW
import sparsematrixmultiplicationmpi_tpu.io.generate as JG
import sparsematrixmultiplicationmpi_tpu.ops as JO
from sparsematrixmultiplicationmpi_tpu.formats.hub import (
    HubExtracted as JHub, split_hub_columns as j_split_hub_columns,
)
import sparsematrixmultiplicationmpi_tpu_torch.formats as TF
import sparsematrixmultiplicationmpi_tpu_torch.formats.windowed as TW
import sparsematrixmultiplicationmpi_tpu_torch.io.generate as TG
import sparsematrixmultiplicationmpi_tpu_torch.ops as TO
from sparsematrixmultiplicationmpi_tpu_torch.formats.hub import (
    HubExtracted as THub, split_hub_columns as t_split_hub_columns,
)
from sparsematrixmultiplicationmpi_tpu_torch.formats.windowed import (
    CompactTiles,
)
from sparsematrixmultiplicationmpi_tpu_torch.ops.oracle import spmm_host_f64
from sparsematrixmultiplicationmpi_tpu_torch.utils.compare import (
    are_matrices_equal, default_tolerance,
)

#: dtype name -> (the JAX package's, the port's)
DTYPES = {"float32": (np.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}

MATRICES = {  # tests/test_ops.py's random and power-law matrices
    "random": lambda g: g.random_csr(120, 90, 1000, seed=1),
    "powerlaw": lambda g: g.powerlaw_csr(150, 150, 2500, seed=3),
}

#: Each basic format from a CSR, by the same call in either package.
FORMATS = {
    "CSR": lambda F, csr: csr,
    "COO": lambda F, csr: csr.to_coo(),
    "ELL": lambda F, csr: F.ELL.from_csr(csr),
    "BucketedELL": lambda F, csr: F.BucketedELL.from_csr(csr),
}


def _jax_dense(j):
    """The JAX package's dense view as host numpy, bf16 as float32."""
    d = np.asarray(j.to_dense())
    return d.astype(np.float32) if d.dtype.itemsize == 2 else d


def _basic(fmt, matrix, dtype):
    jd, td = DTYPES[dtype]
    jc = MATRICES[matrix](JG).astype(np.float32).astype(jd)
    tc = MATRICES[matrix](TG).astype(np.float32).astype(td)
    return FORMATS[fmt](JF, jc), FORMATS[fmt](TF, tc), tc


def _assert_same_view(got, want):
    assert isinstance(got, np.ndarray)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _assert_spmm_dense(j, t, csr, dtype, k=5, seed=11):
    """``spmm_dense`` in ``v``'s dtype on ``v``'s device, the JAX one's
    and the f64 oracle's within the tier of that dtype."""
    jd, td = DTYPES[dtype]
    v = TG.generate_fat_vector(csr.shape[1], k, seed=seed).astype(np.float32)
    vt = torch.from_numpy(v).to(td)
    got = TO.spmm_dense(t, vt)
    assert got.dtype == td and got.device == vt.device
    assert tuple(got.shape) == (t.shape[0], k)
    want = np.asarray(JO.spmm_dense(j, jnp.asarray(v, dtype=jd)))
    assert str(want.dtype) == dtype
    got = got.float().numpy()
    v_used = vt.float().numpy()
    oracle = spmm_host_f64(csr, v_used)
    cond = np.abs(t.to_dense()).astype(np.float64) @ np.abs(v_used)
    tol = default_tolerance(td)
    for ref in (want.astype(np.float32), oracle):
        assert are_matrices_equal(got, ref, tolerance=tol, relative=True,
                                  condition_scale=cond)


# ---- CSR, COO, ELL, BucketedELL -----------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("matrix", MATRICES)
@pytest.mark.parametrize("fmt", FORMATS)
def test_to_dense_matches_jax(fmt, matrix, dtype):
    j, t, _ = _basic(fmt, matrix, dtype)
    want = _jax_dense(j)
    _assert_same_view(t.to_dense(), want)
    # A copy whose arrays are tensors (as on the card) reads the same.
    _assert_same_view(t.to("cpu").to_dense(), want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("fmt", FORMATS)
def test_spmm_dense_matches_jax(fmt, dtype):
    j, t, tc = _basic(fmt, "powerlaw", dtype)
    _assert_spmm_dense(j, t, tc, dtype)
    _assert_spmm_dense(j, t.to("cpu"), tc, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("fmt", FORMATS)
def test_dtype_matches_jax(fmt, dtype):
    j, t, _ = _basic(fmt, "random", dtype)
    assert str(j.dtype) == dtype
    assert t.dtype == DTYPES[dtype][1] == t.to("cpu").dtype


# ---- WindowedPairs and HubExtracted -------------------------------------

#: Windowed builds: U = 16 and U = 2 with a spill and an RCM permutation,
#: U = 2 past the compact width (C = 1024), and a multi-phase layout.
POWERLAW = lambda g: g.powerlaw_csr(2000, 2000, 20000, seed=7)  # noqa: E731
WINDOWED = {
    "U16-spill": (POWERLAW, dict(block_rows=128, chunk_cols=128,
                                 pairs_per_step=16,
                                 beat_gather_margin=np.inf)),
    "U2-spill": (POWERLAW, dict(block_rows=128, chunk_cols=128,
                                pairs_per_step=2, beat_gather_margin=np.inf)),
    "U2-C1024": (POWERLAW, dict(block_rows=128, chunk_cols=1024,
                                pairs_per_step=2, beat_gather_margin=np.inf)),
    "phased": (lambda g: g.banded_csr(512, 24, 8, seed=51),
               dict(block_rows=128, chunk_cols=128, pairs_per_step=16,
                    reorder=None, beat_gather_margin=1e9, max_inflation=1e9,
                    phase_layout=True)),
}


def _multi_phase(W, wp, cpp=2):
    """``wp`` with ``cpp`` chunks per phase (several phases on a small
    matrix), as ``tests/test_phased.py`` rebuilds it."""
    tiles_t, pb_ph, pc_ph, phases = W._phase_fields(
        np.asarray(wp.tiles),
        None if wp.tiles_split is None else np.asarray(wp.tiles_split),
        wp.pair_block, wp.pair_chunk, wp.n_blocks, wp.n_chunks, cpp,
        wp.pairs_per_step)
    extra = ({"block_ptr_ph": W._phase_block_ptr(pb_ph, phases)}
             if W is TW else {})
    out = dataclasses.replace(wp, tiles_t=tiles_t, pair_block_ph=pb_ph,
                              pair_chunk_ph=pc_ph, phases=phases,
                              chunks_per_phase=cpp, **extra)
    assert len(out.phases) > 1
    return out


def _windowed(case, dtype):
    make, kw = WINDOWED[case]
    jd, td = DTYPES[dtype]
    jc, tc = make(JG).astype(np.float32), make(TG).astype(np.float32)
    jw = JW.WindowedPairs.from_csr(jc, **kw)
    tw = TW.WindowedPairs.from_csr(tc, **kw)
    if case == "phased":
        jw, tw = _multi_phase(JW, jw), _multi_phase(TW, tw)
    else:
        assert tw.spill is not None and tw.perm is not None
    return jw.astype(jd), tw.astype(td), tc.astype(td)


def _hub(dtype):
    """dc1 with its hub columns over a windowed remainder with a spill."""
    jd, td = DTYPES[dtype]
    kw = dict(block_rows=128, chunk_cols=128, pairs_per_step=16,
              beat_gather_margin=np.inf)
    ops = []
    for g, split, W, Hub in ((JG, j_split_hub_columns, JW, JHub),
                             (TG, t_split_hub_columns, TW, THub)):
        csr = g.dc1_like(scale=0.02).astype(np.float32)
        ids, dense, rem = split(csr, threshold=csr.shape[0] // 20)
        rem_op = W.WindowedPairs.from_csr(rem, **kw)
        ops.append(Hub(dense_cols=dense, hub_ids=ids, remainder=rem_op,
                       shape=csr.shape))
    jh, th = ops
    assert isinstance(th.remainder, TW.WindowedPairs)
    assert th.remainder.spill is not None and th.n_hubs > 0
    return jh.astype(jd), th.astype(td), csr.astype(td)


def _card_like(t):
    """What a card copy holds, on the CPU: a windowed operand's (or a hub
    remainder's) ``card_planes``, as tensors."""
    if isinstance(t, THub):
        return dataclasses.replace(t, remainder=_card_like(t.remainder))
    return t.card_planes().to("cpu")


def _holds_only_split_planes(t):
    wp = t.remainder if isinstance(t, THub) else t
    return wp.split and wp.card_planes().tiles is None


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", [*WINDOWED, "hub"])
def test_windowed_dense_view_matches_jax(case, dtype):
    j, t, _ = _hub(dtype) if case == "hub" else _windowed(case, dtype)
    want = _jax_dense(j)
    _assert_same_view(t.to_dense(), want)
    _assert_same_view(t.to("cpu").to_dense(), want)
    card = _card_like(t).to_dense()
    if _holds_only_split_planes(t):
        # hi + lo of each f32 value: the kernels' precision.
        assert card.dtype == want.dtype and card.shape == want.shape
        assert np.all(np.abs(card - want) <= 2.0 ** -16 * np.abs(want))
    else:
        _assert_same_view(card, want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ["U16-spill", "U2-spill", "hub"])
def test_windowed_spmm_dense_matches_jax(case, dtype):
    j, t, csr = _hub(dtype) if case == "hub" else _windowed(case, dtype)
    _assert_spmm_dense(j, t, csr, dtype)
    _assert_spmm_dense(j, _card_like(t), csr, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", WINDOWED)
def test_windowed_dense_bytes_match_jax(case, dtype):
    j, t, _ = _windowed(case, dtype)
    assert t.dense_bytes == j.dense_bytes > 0
    card = _card_like(t)
    assert card.dense_bytes == j.dense_bytes
    assert t.dtype == card.dtype == DTYPES[dtype][1]
    # The card's planes: compact where its kernels read them.
    held = [card.tiles, card.tiles_split, card.tiles_t]
    assert any(isinstance(x, CompactTiles) for x in held) == (
        case != "U2-C1024")
