"""Parity of the PyTorch port's format builders with the JAX package: RCM,
the band-dense builder, the windowed tile search and layout (pair lists,
dense tiles, bf16 hi|lo split planes compared as uint16 bits, transposed
planes, spill), the gather-class estimates and ``auto_format``'s pick.
All host-side numpy: every array must be bit-identical.
"""

import dataclasses

import numpy as np
import pytest

import sparsematrixmultiplicationmpi_tpu.formats.banded as JB
import sparsematrixmultiplicationmpi_tpu.formats.reorder as JR
import sparsematrixmultiplicationmpi_tpu.formats.windowed as JW
import sparsematrixmultiplicationmpi_tpu.io.generate as JG
import sparsematrixmultiplicationmpi_tpu.ops.auto as JA
import sparsematrixmultiplicationmpi_tpu_torch.formats.banded as TB
import sparsematrixmultiplicationmpi_tpu_torch.formats.reorder as TR
import sparsematrixmultiplicationmpi_tpu_torch.formats.windowed as TW
import sparsematrixmultiplicationmpi_tpu_torch.io.generate as TG
import sparsematrixmultiplicationmpi_tpu_torch.ops.auto as TA


def _both(make, dtype=np.float32):
    return make(JG).astype(dtype), make(TG).astype(dtype)


def _bits(x):
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.itemsize == 2 else x


def assert_windowed_equal(jw, tw):
    """Every field the port keeps, bit for bit."""
    assert type(tw).__name__ == "WindowedPairs"
    for f in ("shape", "block_rows", "chunk_cols", "est_seconds",
              "pairs_per_step"):
        assert tuple(np.atleast_1d(getattr(jw, f))) == \
            tuple(np.atleast_1d(getattr(tw, f))), f
    for f in ("pair_block", "pair_chunk", "block_ptr", "tiles", "perm",
              "inv_perm", "tiles_split", "tiles_t"):
        a, b = getattr(jw, f), getattr(tw, f)
        assert (a is None) == (b is None), f
        if a is not None:
            a = _bits(a)
            assert a.dtype == b.dtype and a.shape == b.shape, f
            np.testing.assert_array_equal(a, b, err_msg=f)
    assert (jw.spill is None) == (tw.spill is None)
    if jw.spill is not None:
        for x, y in zip(jw.spill.buckets, tw.spill.buckets):
            np.testing.assert_array_equal(np.asarray(x.cols), y.cols)
            np.testing.assert_array_equal(np.asarray(x.vals), y.vals)
        np.testing.assert_array_equal(np.asarray(jw.spill.inv_row_perm),
                                      tw.spill.inv_row_perm)
    assert jw.pad_rows == tw.pad_rows
    assert jw.supports_transposed_chain == tw.supports_transposed_chain


@pytest.mark.parametrize("make", [
    lambda g: g.fem3d_csr(1000, 20000, seed=1),
    lambda g: g.cop20k_like(scale=0.02, seed=2),
    lambda g: g.banded_csr(600, 30, 8, seed=3),
    lambda g: g.roadnet_like(scale=0.002, seed=4),
], ids=["fem3d", "cop20k", "banded", "roadnet"])
def test_rcm_permutation_bit_identical(make):
    jc, tc = _both(make)
    np.testing.assert_array_equal(JR.rcm_ordering(jc), TR.rcm_ordering(tc))
    assert JR.bandwidth(jc) == TR.bandwidth(tc)


@pytest.mark.parametrize("kw", [{}, dict(block_rows=64), dict(k_nominal=8)],
                         ids=["search", "pinned", "k8"])
def test_banded_blocks_builder_bit_identical(kw):
    jc, tc = _both(lambda g: g.banded_csr(3000, 40, 10, seed=5))
    jb, tb = JB.BandedBlocks.from_csr(jc, **kw), TB.BandedBlocks.from_csr(
        tc, **kw)
    assert (jb is None) == (tb is None)
    assert jb.block_rows == tb.block_rows
    assert jb.est_seconds == tb.est_seconds
    np.testing.assert_array_equal(np.asarray(jb.band), tb.band)
    assert (jb.spill is None) == (tb.spill is None)
    assert TB.band_coverage(tc, 128) == JB.band_coverage(jc, 128)


def test_banded_blocks_refusal_matches():
    jc, tc = _both(lambda g: g.random_csr(2000, 2000, 20000, seed=6))
    assert JB.BandedBlocks.from_csr(jc) is None
    assert TB.BandedBlocks.from_csr(tc) is None


BUILDS = {
    # (matrix, from_csr kwargs): the test_tmulti / test_windowed families
    "fem3d256-U4": (lambda g: g.fem3d_csr(256, 4096, seed=0),
                    dict(block_rows=16, chunk_cols=128, reorder=None,
                         pairs_per_step=4, beat_gather_margin=1e9,
                         max_inflation=1e9)),
    "fem3d256-U16": (lambda g: g.fem3d_csr(256, 4096, seed=0),
                     dict(block_rows=16, chunk_cols=128, reorder=None,
                          pairs_per_step=16, beat_gather_margin=1e9,
                          max_inflation=1e9)),
    "spans-R8": (lambda g: g.fem3d_csr(512, 8192, seed=2),
                 dict(block_rows=8, chunk_cols=128, reorder=None,
                      pairs_per_step=8, beat_gather_margin=1e9,
                      max_inflation=1e9)),
    "square-chain": (lambda g: g.banded_csr(512, 24, 8, seed=4),
                     dict(block_rows=128, chunk_cols=128, reorder=None,
                          pairs_per_step=8, beat_gather_margin=1e9,
                          max_inflation=1e9)),
    "spill": (lambda g: g.powerlaw_csr(2000, 2000, 20000, seed=7),
              dict(block_rows=128, chunk_cols=128, pairs_per_step=8,
                   beat_gather_margin=np.inf)),
    "U2-even-runs": (lambda g: g.fem3d_csr(1024, 16000, seed=8),
                     dict(pairs_per_step=2, beat_gather_margin=1e9)),
    "fem3d1024-auto": (lambda g: g.fem3d_csr(1024, 16000, seed=9), {}),
    "cop20k-0.02": (lambda g: g.cop20k_like(scale=0.02), {}),
    "cop20k-0.05": (lambda g: g.cop20k_like(scale=0.05), {}),
    "cop20k-square": (lambda g: g.cop20k_like(scale=0.03),
                      dict(block_rows=128, chunk_cols=128)),
}


@pytest.mark.parametrize("name", sorted(BUILDS))
def test_windowed_from_csr_bit_identical(name):
    make, kw = BUILDS[name]
    jc, tc = _both(make)
    jw, tw = JW.WindowedPairs.from_csr(jc, **kw), TW.WindowedPairs.from_csr(
        tc, **kw)
    assert (jw is None) == (tw is None)
    if jw is not None:
        assert_windowed_equal(jw, tw)


def test_windowed_f64_build_has_one_plane():
    jc, tc = _both(lambda g: g.fem3d_csr(256, 4096, seed=0), np.float64)
    kw = BUILDS["fem3d256-U4"][1]
    jw, tw = JW.WindowedPairs.from_csr(jc, **kw), TW.WindowedPairs.from_csr(
        tc, **kw)
    assert tw.tiles_split is None and tw.tiles_t.dtype == np.float64
    assert_windowed_equal(jw, tw)


def test_windowed_refusals_match():
    jc, tc = _both(lambda g: g.random_csr(3000, 3000, 30000, seed=10))
    kw = dict(candidates=(64, 128))
    assert JW.WindowedPairs.from_csr(jc, **kw) is None
    assert TW.WindowedPairs.from_csr(tc, **kw) is None
    assert JW.windowed_wins(jc) == TW.windowed_wins(tc)


def test_split_planes_bits_match():
    rng = np.random.default_rng(11)
    x = rng.normal(scale=100.0, size=(3, 16, 8)).astype(np.float32)
    x.flat[:8] = [0.0, -0.0, 1.0, 3.0039062, 1e-38, -1e-40, 65504.0,
                  1.00390625]  # ties, subnormals, exact values
    np.testing.assert_array_equal(_bits(JW._split_planes(x)),
                                  TW._split_planes(x))
    assert TW._split_planes(x.astype(np.float64)) is None


@pytest.mark.parametrize("i,j", [(0, 0), (1, 1), (2, 0)])
def test_cost_estimates_match(i, j):
    jc, tc = _both(lambda g: g.fem3d_csr(800, 12000, seed=12))
    coo = tc.to_coo()
    ii = coo.row_indices.astype(np.int64)
    jj = coo.col_indices.astype(np.int64)
    R, C = (64, 128, 256)[i], (128, 256)[j]
    a = JW.windowed_cost_estimate(ii, jj, 800, 800, R, C, 4, 32, 16)
    b = TW.windowed_cost_estimate(ii, jj, 800, 800, R, C, 4, 32, 16)
    assert a[0] == b[0] and a[1] == b[1]
    np.testing.assert_array_equal(a[2], b[2])
    vals = coo.values
    for x, y in zip(JW.build_dense_pairs(ii, jj, vals, 800, 800, R, C, 4),
                    TW.build_dense_pairs(ii, jj, vals, 800, 800, R, C, 4)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("k", [1, 6, 32, 128])
def test_gather_class_estimates_match(k):
    jc, tc = _both(lambda g: g.powerlaw_csr(3000, 3000, 30000, seed=13))
    je, te = JA.gather_class_estimates(jc, k), TA.gather_class_estimates(
        tc, k)
    assert je["coo"][0] == te["coo"][0]
    assert je["bucketed_ell"][0] == te["bucketed_ell"][0]
    for work in (1000, 10 ** 6):
        assert JA._calibrated_gather_seconds("ell", work, 50000, k) == \
            TA._calibrated_gather_seconds("ell", work, 50000, k)


AUTO = {
    "fem3d": (lambda g: g.fem3d_csr(3000, 60000, seed=14), 32),
    "banded": (lambda g: g.banded_csr(6000, 40, 12, seed=15), 8),
    "random": (lambda g: g.random_csr(5000, 5000, 40000, seed=16), 32),
    "powerlaw": (lambda g: g.powerlaw_csr(5000, 5000, 40000, seed=17), 1),
    "cop20k": (lambda g: g.cop20k_like(scale=0.03, seed=18), 32),
}


@pytest.mark.parametrize("name", sorted(AUTO))
def test_auto_format_pick_matches(name):
    make, k = AUTO[name]
    jc, tc = _both(make)
    jo, to = JA.auto_format(jc, k_nominal=k), TA.auto_format(tc, k_nominal=k)
    assert type(jo).__name__ == type(to).__name__
    if type(to).__name__ == "WindowedPairs":
        assert_windowed_equal(jo, to)
    elif type(to).__name__ == "BandedBlocks":
        assert jo.block_rows == to.block_rows
        assert jo.est_seconds == to.est_seconds
    elif type(to).__name__ == "BucketedELL":
        np.testing.assert_array_equal(np.asarray(jo.row_perm), to.row_perm)


def test_from_arrays_takes_the_jax_operand():
    jc, tc = _both(BUILDS["spill"][0])
    kw = BUILDS["spill"][1]
    jw = JW.WindowedPairs.from_csr(jc, **kw)
    assert jw.spill is not None
    fields = {f.name: getattr(jw, f.name) for f in dataclasses.fields(jw)}
    tw = TW.WindowedPairs.from_arrays(**fields)
    assert_windowed_equal(jw, tw)
    assert_windowed_equal(jw, TW.WindowedPairs.from_csr(tc, **kw))


def test_unported_options_raise():
    jc, tc = _both(lambda g: g.fem3d_csr(256, 4096, seed=0))
    # phase_layout=True is ported (kernel B6): the build matches the JAX
    # package's.
    kw = dict(phase_layout=True, beat_gather_margin=1e9, max_inflation=1e9)
    jw, tw = JW.WindowedPairs.from_csr(jc, **kw), TW.WindowedPairs.from_csr(
        tc, **kw)
    assert_windowed_equal(jw, tw)
    assert (tw.phases is None) == (jw.phases is None)
    with pytest.raises(NotImplementedError, match="hub"):
        TA.auto_format(tc, allow_hub=True)
    with pytest.raises(ValueError, match="pairs_per_step"):
        TW.WindowedPairs.from_csr(tc, pairs_per_step=1)
