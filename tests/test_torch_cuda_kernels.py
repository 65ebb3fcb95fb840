"""Card-only tests of the port's CUDA kernels (B1-B7) against their plain
PyTorch versions and the host f64 oracle.

Every test here needs an NVIDIA GPU and ``nvcc``; elsewhere each one
skips from inside the ``cuda`` fixture. The file imports no JAX, so it
runs on a machine without it:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda_kernels.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from sparsematrixmultiplicationmpi_tpu_torch.bench.systems import (
    spd_banded_system,
)
from sparsematrixmultiplicationmpi_tpu_torch.formats.banded import (
    BandedBlocks,
)
from sparsematrixmultiplicationmpi_tpu_torch.formats.matrix import (
    COO, ELL, BucketedELL,
)
from sparsematrixmultiplicationmpi_tpu_torch.formats.windowed import (
    CompactTiles, WindowedPairs, _phase_block_ptr, _phase_fields,
)
from sparsematrixmultiplicationmpi_tpu_torch.io.generate import (
    banded_csr, fem3d_csr, generate_fat_vector, powerlaw_csr, random_csr,
)
from sparsematrixmultiplicationmpi_tpu_torch.models import conjugate_gradient
from sparsematrixmultiplicationmpi_tpu_torch.ops import cuda_banded as cb
from sparsematrixmultiplicationmpi_tpu_torch.ops import cuda_gather as cg
from sparsematrixmultiplicationmpi_tpu_torch.ops import ell as ell_ops
from sparsematrixmultiplicationmpi_tpu_torch.ops import cuda_windowed as cw
from sparsematrixmultiplicationmpi_tpu_torch.ops.auto import spmm_any
from sparsematrixmultiplicationmpi_tpu_torch.ops.oracle import spmm_host_f64
from sparsematrixmultiplicationmpi_tpu_torch.ops.windowed import (
    _finish, spmm_windowed, windowed_t_chain,
)

pytestmark = pytest.mark.gpu

#: B1 against its plain version: both sum exact bf16 x bf16 products in
#: f32, in another order; |diff| <= RTOL * cond + ATOL with cond the
#: plain B1 on the planes' absolute values. B5 the same, with cond the
#: plain B5 on |band|, |v|; a bf16 band's result is rounded to bf16 once
#: on each side, so its bound adds one bf16 ulp, BF16_ULP * |plain|.
RTOL, ATOL = 1e-5, 1e-6
BF16_ULP = 2.0 ** -7


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _wp(csr, *, U, R, C=128, reorder=None):
    wp = WindowedPairs.from_csr(
        csr, block_rows=R, chunk_cols=C, reorder=reorder,
        pairs_per_step=U, beat_gather_margin=1e9, max_inflation=1e9)
    assert wp is not None
    return wp


def _compact(host, dev):
    """The B1 / B6 kernels' operand for a host ``WindowedPairs``: its
    ``tiles_t`` as a ``CompactTiles`` on ``dev`` (what ``to`` keeps on a
    card for an ``R % 128 == 0`` operand; built here for the others)."""
    return CompactTiles.from_dense(host.tiles_t, host.split).to(dev)


def _slabs(wp, k, dev, seed):
    v = generate_fat_vector(wp.shape[1], k, seed=seed).astype(np.float32)
    v_p = wp.encode(torch.from_numpy(v).to(dev)).contiguous()
    return v, v_p, cw.chunk_slabs(v_p, C=wp.chunk_cols, split=True)


def _counts(**nonzero):
    """The windowed kernels' launch counts: zero but for ``nonzero``."""
    return {**dict.fromkeys(("B1", "B2", "B3", "B4", "B6"), 0), **nonzero}


def _assert_b1_close(got, want, cond):
    assert got.shape == want.shape and got.dtype == want.dtype
    diff = (got.float() - want.float()).abs()
    assert bool((diff <= RTOL * cond + ATOL).all()), float(diff.max())


@pytest.mark.parametrize("k", [8, 16, 32, 40])
@pytest.mark.parametrize("split", [True, False])
def test_chunk_slabs_bitwise(cuda, k, split):
    rng = np.random.default_rng(k)
    v = torch.from_numpy(
        rng.uniform(-50, 50, size=(512, k)).astype(np.float32)).to(cuda)
    got = cw.chunk_slabs(v, C=128, split=split)
    want = cw.chunk_slabs_plain(v, C=128, split=split)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.equal(got, want)


def test_chunk_slabs_bf16_plain_mode(cuda):
    v = torch.randn(256, 16, device=cuda).to(torch.bfloat16)
    assert torch.equal(cw.chunk_slabs(v, C=128, split=False),
                       cw.chunk_slabs_plain(v, C=128, split=False))


@pytest.mark.parametrize("U", [4, 8, 16])
def test_tmulti_matches_plain(cuda, U):
    csr = fem3d_csr(256, 4096, seed=0).astype(np.float32)
    host = _wp(csr, U=U, R=16)
    wp, ct = host.to(cuda), _compact(host, cuda)
    _, _, slabs = _slabs(wp, 16, cuda, seed=1)
    got = cw.windowed_matmul_tmulti(
        wp.pair_block, wp.pair_chunk, wp.block_ptr, ct, slabs,
        nb=wp.n_blocks, pairs_per_step=U)
    want = cw.windowed_matmul_tmulti_plain(
        wp.pair_block, wp.pair_chunk, wp.tiles_t, slabs, nb=wp.n_blocks)
    cond = cw.windowed_matmul_tmulti_plain(
        wp.pair_block, wp.pair_chunk, wp.tiles_t.abs(), slabs.abs(),
        nb=wp.n_blocks)
    _assert_b1_close(got, want, cond)
    # The fused epilogue is the exact bf16 split of the same f32 sum.
    fused = cw.windowed_matmul_tmulti(
        wp.pair_block, wp.pair_chunk, wp.block_ptr, ct, slabs,
        nb=wp.n_blocks, pairs_per_step=U, fuse_resplit=True)
    assert torch.equal(fused.view(torch.int16),
                       cw.resplit_slabs(got).view(torch.int16))


def test_tmulti_spans_blocks_mid_step(cuda):
    csr = fem3d_csr(512, 8192, seed=2).astype(np.float32)
    host = _wp(csr, U=8, R=8)
    assert (np.diff(host.block_ptr) % 8 != 0).any()
    wp = host.to(cuda)
    v, v_p, slabs = _slabs(wp, 16, cuda, seed=3)
    got = cw.windowed_matmul_tmulti(
        wp.pair_block, wp.pair_chunk, wp.block_ptr, _compact(host, cuda),
        slabs, nb=wp.n_blocks, pairs_per_step=8)
    computed = got.transpose(1, 2).reshape(wp.n_blocks * 8, 16)
    out = wp.decode(_finish(wp, computed, v_p))  # + the spill, if any
    ref = spmm_host_f64(csr, v)
    err = np.abs(out.cpu().double().numpy() - ref).max() / np.abs(ref).max()
    assert err < 5e-3


def test_tmulti_empty_run_writes_zeros(cuda):
    csr = fem3d_csr(256, 4096, seed=0).astype(np.float32)
    host = _wp(csr, U=8, R=16)
    wp = host.to(cuda)
    _, _, slabs = _slabs(wp, 16, cuda, seed=4)
    bp = wp.block_ptr.clone()
    bp[1] = bp[0]  # block 0's run becomes empty
    out = cw.windowed_matmul_tmulti(
        wp.pair_block, wp.pair_chunk, bp, _compact(host, cuda), slabs,
        nb=wp.n_blocks, pairs_per_step=8)
    assert torch.count_nonzero(out[0]) == 0


def _hazard_operand(C, R, split, seed):
    """A B1 operand built to hit the compact plane's edge cases: blocks
    with empty runs (1 and 4), a tile with no entries, a fully dense tile
    (at C = R = 256 its C * R entries need int32 column offsets, at
    C = 512 the contraction index int16), a full column (C entries in one
    r), a -0.0 entry, and ~2 % of the other positions. Returns
    ``(pair_block, pair_chunk, block_ptr, tiles_t, nb, n_chunks)`` on the
    host; ``tiles_t`` bf16 bits, hi | lo planes with ``split``."""
    rng = np.random.default_rng(seed)
    nb, n_chunks, P = 6, 5, 16
    pb = np.sort(rng.choice([0, 2, 3, 5], size=P)).astype(np.int32)
    pc = rng.integers(0, n_chunks, P).astype(np.int32)
    bp = np.searchsorted(pb, np.arange(nb + 1)).astype(np.int32)
    x = rng.uniform(-1, 1, (P, C, R)).astype(np.float32)
    keep = rng.random((P, C, R)) < 0.02
    keep[0] = True            # fully dense
    keep[1] = False           # no entries
    keep[2, :, R - 1] = True  # a full column
    x = np.where(keep, x, np.float32(0))
    x[3, 0, 0] = -0.0
    t = torch.from_numpy(x)
    hi = t.to(torch.bfloat16)
    planes = [hi, (t - hi.float()).to(torch.bfloat16)] if split else [hi]
    tiles_t = torch.cat(planes, dim=1)
    return pb, pc, bp, tiles_t, nb, n_chunks


#: Every hazard of the compact plane against the plain version: index
#: widths (uint16 / int32 column offsets, uint8 / int16 rows), R = 8 (one
#: warp's half), R = 256 (two column slices), k8 below a warp, at one
#: and past one k8 slice, split planes and one plane.
@pytest.mark.parametrize("split", [True, False], ids=["split", "one-plane"])
@pytest.mark.parametrize("k8", [8, 16, 32, 64])
@pytest.mark.parametrize("C,R", [(128, 128), (128, 8), (256, 256),
                                 (512, 128)])
def test_tmulti_compact_hazards(cuda, C, R, k8, split):
    pb, pc, bp, tiles_t, nb, n_chunks = _hazard_operand(C, R, split,
                                                        seed=C + R + k8)
    ct = CompactTiles.from_dense(tiles_t, split)
    assert ct.wide == (int(C * R > 65535) | int(C > 256) << 1)
    np.testing.assert_array_equal(
        ct.to_dense(), tiles_t.view(torch.int16).numpy().view(np.uint16))
    ct = ct.to(cuda)
    pb, pc, bp = (torch.from_numpy(a).to(cuda) for a in (pb, pc, bp))
    dense = tiles_t.to(cuda)
    v = torch.from_numpy(np.random.default_rng(k8).uniform(
        -50, 50, (n_chunks * C, k8)).astype(np.float32)).to(cuda)
    slabs = (cw.chunk_slabs(v, C=C, split=True) if split else
             cw.chunk_slabs(v.to(torch.bfloat16), C=C, split=False))
    kw = dict(nb=nb, pairs_per_step=8, split=split)
    cw.reset_launch_counts()
    got = cw.windowed_matmul_tmulti(pb, pc, bp, ct, slabs, **kw)
    assert cw.launch_counts() == _counts(B1=1)
    want = cw.windowed_matmul_tmulti_plain(pb, pc, dense, slabs, nb=nb,
                                           split=split)
    cond = cw.windowed_matmul_tmulti_plain(pb, pc, dense.abs(), slabs.abs(),
                                           nb=nb, split=split)
    torch.cuda.synchronize()
    _assert_b1_close(got, want, cond)
    assert torch.count_nonzero(got[1]) == torch.count_nonzero(got[4]) == 0
    if split and k8 % 16 == 0:
        fused = cw.windowed_matmul_tmulti(pb, pc, bp, ct, slabs,
                                          fuse_resplit=True, **kw)
        assert torch.equal(fused.view(torch.int16),
                           cw.resplit_slabs(got).view(torch.int16))


def test_dense_tiles_on_the_card_raise(cuda):
    pb, pc, bp, tiles_t, nb, _ = _hazard_operand(128, 128, True, seed=0)
    pb, pc, bp = (torch.from_numpy(a).to(cuda) for a in (pb, pc, bp))
    slabs = torch.zeros((5, 16, 256), dtype=torch.bfloat16, device=cuda)
    cw.reset_launch_counts()
    with pytest.raises(ValueError, match="dense tiles_t"):
        cw.windowed_matmul_tmulti(pb, pc, bp, tiles_t.to(cuda), slabs, nb=nb)
    phases = ((0, 16, 0, 0, nb),)
    with pytest.raises(ValueError, match="dense tiles_t"):
        cw.windowed_matmul_tmulti_phased(
            pb, pc, bp, tiles_t.to(cuda), slabs, nb=nb, phases=phases,
            chunks_per_phase=5, pairs_per_step=8)
    assert cw.launch_counts() == _counts()


def _csr_product(csr, v):
    """``csr @ v`` summing the stored entries only (scipy), so a
    non-finite ``v[j]`` reaches just the rows that hold column j."""
    import scipy.sparse

    a = scipy.sparse.csr_matrix(
        (np.asarray(csr.values, np.float64), csr.col_indices, csr.row_ptr),
        shape=csr.shape)
    return a @ v.astype(np.float64)


def test_tmulti_nonfinite_v_reaches_only_its_entries(cuda):
    """The port's divergence from the reference (ROADMAP C): the compact
    kernel multiplies no stored zero, so an Inf or NaN in ``v`` makes
    non-finite exactly the rows a CSR product does, where the dense-tile
    plain version (and the TPU kernel) spread it over whole tiles."""
    csr = banded_csr(512, 24, 8, seed=4).astype(np.float32)
    wp = _wp(csr, U=8, R=128).to(cuda)
    v = generate_fat_vector(512, 16, seed=9).astype(np.float32)
    v[100, 3], v[300, 7], v[301, 7] = np.inf, np.nan, -np.inf
    cw.reset_launch_counts()
    out = spmm_windowed(wp, torch.from_numpy(v).to(cuda)).cpu().numpy()
    assert cw.launch_counts() == _counts(B1=1, B2=1)
    ref = _csr_product(csr, v)
    bad = ~np.isfinite(ref)
    assert bad.any() and bad.sum() < bad.size
    np.testing.assert_array_equal(~np.isfinite(out), bad)
    err = np.abs(out[~bad] - ref[~bad]).max() / np.abs(ref[~bad]).max()
    assert err < 5e-3
    plain = spmm_windowed(wp.to("cpu"), torch.from_numpy(v)).numpy()
    assert (~np.isfinite(plain)).sum() > bad.sum()


def test_kernels_count_launches(cuda):
    csr = fem3d_csr(256, 4096, seed=0).astype(np.float32)
    host = _wp(csr, U=8, R=16)
    wp, ct = host.to(cuda), _compact(host, cuda)
    cw.reset_launch_counts()
    _, _, slabs = _slabs(wp, 16, cuda, seed=5)
    cw.windowed_matmul_tmulti(
        wp.pair_block, wp.pair_chunk, wp.block_ptr, ct, slabs,
        nb=wp.n_blocks, pairs_per_step=8)
    assert cw.launch_counts() == _counts(B1=1, B2=1)


def test_card_copy_holds_only_what_its_route_reads(cuda):
    csr = banded_csr(512, 24, 8, seed=4).astype(np.float32)
    host = _wp(csr, U=8, R=128)
    wp = host.to(cuda)
    assert wp.tiles is None and wp.tiles_split is None
    # The kernels read the compact plane, which stands in for tiles_t.
    assert isinstance(wp.tiles_t, CompactTiles)
    assert wp.tiles_t.device == cuda and wp.split
    assert wp.n_pairs == host.n_pairs
    np.testing.assert_array_equal(
        wp.tiles_t.to_dense().cpu().view(torch.int16).numpy().view(
            np.uint16), host.tiles_t)
    # R % 128 != 0: the card runs the plain path on the natural planes.
    r16 = _wp(fem3d_csr(256, 4096, seed=0).astype(np.float32), U=8,
              R=16).to(cuda)
    assert r16.tiles is not None and r16.tiles_split is not None
    # Narrow unaligned k is zero-padded to 8 and runs the kernels too.
    v = generate_fat_vector(512, 5, seed=7).astype(np.float32)
    cw.reset_launch_counts()
    out = spmm_windowed(wp, torch.from_numpy(v).to(cuda))
    assert cw.launch_counts() == _counts(B1=1, B2=1)
    ref = spmm_host_f64(csr, v)
    err = np.abs(out.cpu().double().numpy() - ref).max() / np.abs(ref).max()
    assert err < 5e-3


def test_chain_on_card_matches_oracle(cuda):
    csr = banded_csr(512, 24, 8, seed=4).astype(np.float32)
    wp = _wp(csr, U=8, R=128).to(cuda)
    assert wp.supports_transposed_chain
    v = generate_fat_vector(512, 16, seed=6).astype(np.float32)
    enc, body, dec = windowed_t_chain(wp, 16)
    cw.reset_launch_counts()
    out = dec(body(enc(torch.from_numpy(v).to(cuda), wp), wp), wp)
    assert cw.launch_counts() == _counts(B1=1, B2=1)
    ref = spmm_host_f64(csr, v)
    err = np.abs(out.cpu().double().numpy() - ref).max() / np.abs(ref).max()
    assert err < 5e-3
    one_shot = spmm_windowed(wp, torch.from_numpy(v).to(cuda))
    err = np.abs(one_shot.cpu().double().numpy() - ref).max() / \
        np.abs(ref).max()
    assert err < 5e-3


def _rel_to_oracle(out, csr, v):
    ref = spmm_host_f64(csr, v)
    return np.abs(out.cpu().double().numpy() - ref).max() / np.abs(ref).max()


#: Widths around B5's column chunk: one short, one chunk, one over (a
#: ragged last chunk of one column) and two chunks and a ragged third.
KC = cb.BAND_K_CHUNK
BAND_WIDTHS = [1, 6, 8, 32, KC - 1, KC, KC + 1, 2 * KC + 3]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", BAND_WIDTHS)
@pytest.mark.parametrize("r", [8, 72, 128])
def test_band_matmul_matches_plain(cuda, r, k, dtype):
    """r = 8 and 72 fill half of their last m16 tile."""
    nb = 5
    rng = np.random.default_rng(r * 1000 + k)
    band = rng.uniform(-1, 1, (nb, r, 3 * r)).astype(np.float32)
    band[rng.uniform(size=band.shape) > 0.1] = 0.0
    band = torch.from_numpy(band).to(cuda, dtype)
    # A ragged end: v stops 3 rows short, the output 2 rows short.
    v = torch.from_numpy(rng.uniform(-1, 1, (nb * r - 3, k)).astype(
        np.float32)).to(cuda, dtype)
    m = nb * r - 2
    got = cb.band_matmul(band, v, m=m)
    want = cb.band_matmul_plain(band, v, m=m)
    cond = cb.band_matmul_plain(band.float().abs(), v.float().abs(), m=m)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (m, k)
    assert got.dtype == want.dtype == dtype
    bound = RTOL * cond + ATOL
    if dtype == torch.bfloat16:
        bound = bound + BF16_ULP * want.float().abs()
    diff = (got.float() - want.float()).abs()
    assert bool((diff <= bound).all()), float(diff.max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_band_matmul_takes_an_unaligned_v(cuda, dtype):
    """v's rows 16-byte aligned (k = 8) but its base 4 bytes past an
    allocation's: the kernel stages it element by element."""
    nb, r, k = 3, 128, 8
    rng = np.random.default_rng(7)
    band = torch.from_numpy(rng.uniform(-1, 1, (nb, r, 3 * r)).astype(
        np.float32)).to(cuda, dtype)
    flat = torch.from_numpy(rng.uniform(-1, 1, nb * r * k + 2).astype(
        np.float32)).to(cuda, dtype)
    v = flat[2:].view(nb * r, k)
    assert v.data_ptr() % 16 != 0
    got = cb.band_matmul(band, v)
    want = cb.band_matmul_plain(band, v)
    cond = cb.band_matmul_plain(band.float().abs(), v.float().abs())
    bound = RTOL * cond + ATOL
    if dtype == torch.bfloat16:
        bound = bound + BF16_ULP * want.float().abs()
    assert bool(((got.float() - want.float()).abs() <= bound).all())


def test_band_spill_on_card_matches_plain_and_oracle(cuda):
    """The spill family of ``tests/test_pallas.py``: B5 plus the spill."""
    dense = (banded_csr(200, 4, 3, seed=133).to_dense()
             + random_csr(200, 200, 250, seed=134).to_dense())
    rows, cols = np.nonzero(dense)
    csr = COO.from_arrays(dense[rows, cols], rows, cols,
                          dense.shape).to_csr().astype(np.float32)
    bb = BandedBlocks.from_csr(csr, block_rows=8)
    assert bb.spill is not None
    bb = bb.to(cuda)
    v = generate_fat_vector(200, 5, seed=135).astype(np.float32)
    cb.reset_launch_counts()
    out = spmm_any(bb, torch.from_numpy(v).to(cuda))
    assert cb.launch_counts() == {"B5": 1}
    assert _rel_to_oracle(out, csr, v) < 1e-4


def test_band_kernel_counts_launches_on_its_route_only(cuda):
    csr = banded_csr(1024, 40, 8, seed=3).astype(np.float32)
    v = torch.from_numpy(generate_fat_vector(1024, 8, seed=4).astype(
        np.float32))
    cb.reset_launch_counts()
    for r in (128, 256):
        out = spmm_any(BandedBlocks.from_csr(csr, block_rows=r).to(cuda),
                       v.to(cuda))
        assert _rel_to_oracle(out, csr, v.numpy()) < 5e-3
    spmm_any(BandedBlocks.from_csr(csr, block_rows=128).to("cpu"), v)
    assert cb.launch_counts() == {"B5": 1}  # r = 256 takes the plain path


def test_band_matmul_rejects_what_the_kernel_does_not_take(cuda):
    band = torch.zeros((2, 8, 24), device=cuda)
    v = torch.zeros((16, 4), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        cb.band_matmul(band, torch.zeros((4, 16), device=cuda).T)
    with pytest.raises(ValueError, match="v must be torch.float32"):
        cb.band_matmul(band, v.double())
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        cb.band_matmul(band.double(), v.double())
    with pytest.raises(ValueError, match="r <= 128"):
        cb.band_matmul(torch.zeros((1, 256, 768), device=cuda),
                       torch.zeros((256, 4), device=cuda))
    cb.reset_launch_counts()
    assert cb.band_matmul(band, v).shape == (16, 4)
    assert cb.launch_counts() == {"B5": 1}


def test_cg_on_card_runs_b5_once_per_iteration(cuda):
    csr = spd_banded_system(4096, seed=2)
    op = BandedBlocks.from_csr(csr, block_rows=128).to(cuda)
    b = np.random.default_rng(3).normal(size=(4096, 8)).astype(np.float32)
    cb.reset_launch_counts()
    res = conjugate_gradient(lambda x: spmm_any(op, x),
                             torch.from_numpy(b).to(cuda), tol=1e-5,
                             max_iter=200)
    assert cb.launch_counts() == {"B5": res.iterations + 1}
    x = res.x.cpu().double().numpy()
    resid = b - spmm_host_f64(csr, x)
    assert (np.linalg.norm(resid, axis=0)
            / np.linalg.norm(b, axis=0)).max() < 1e-4


# ---- B3 / B4: the two-pair natural-layout kernels -------------------------

#: Every (R, C) of ``DEFAULT_CANDIDATES`` with R in {8, 64, 256, 512}.
NATURAL_SHAPES = [(8, 128), (64, 128), (64, 256), (256, 128), (256, 256),
                  (256, 512), (512, 512)]


def _u2(csr, R, C):
    wp = WindowedPairs.from_csr(
        csr, block_rows=R, chunk_cols=C, reorder=None, pairs_per_step=2,
        beat_gather_margin=1e9, max_inflation=1e9, allow_spill=False)
    assert wp is not None and wp.n_pairs % 2 == 0 and wp.spill is None
    return wp


def _natural_case(host, mode, v_p, dev):
    """(kernel, plain, tiles, dense, slabs) of one two-pair mode: the
    kernel's tile operand (split3 and bf16: the natural compact plane,
    what ``to`` keeps on a card; f32: the dense tiles) and the dense
    plane the plain version reads."""
    C = host.chunk_cols
    if mode == "split3":
        tiles = CompactTiles.from_natural(host.tiles_split, True).to(dev)
        slabs = cw.chunk_slabs(v_p, C=C, split=True)
        return (cw.windowed_matmul_split3, cw.windowed_matmul_split3_plain,
                tiles, tiles.to_dense(), slabs)
    dtype = torch.bfloat16 if mode == "bf16" else torch.float32
    slabs = cw.chunk_slabs(v_p.to(dtype).contiguous(), C=C, split=False)
    if mode == "bf16":
        tiles = CompactTiles.from_natural(
            torch.from_numpy(host.tiles).to(dtype), False).to(dev)
        return (cw.windowed_matmul_single, cw.windowed_matmul_single_plain,
                tiles, tiles.to_dense(), slabs)
    tiles = torch.from_numpy(host.tiles).to(dev).to(dtype)
    if mode == "f32-full":
        tiles, slabs = _full_mantissa(tiles, 0), _full_mantissa(slabs, 1)
    return (cw.windowed_matmul_single, cw.windowed_matmul_single_plain,
            tiles, tiles, slabs)


def _full_mantissa(x, seed):
    """``x * (1 + 2**-12 u)``, u uniform in [-1, 1): all 24 bits of the
    mantissa in use, so B4 f32's 3xTF32 split is exercised (the tiles of
    a build hold ~17 bits and the fat vector integers, which two TF32
    terms represent exactly)."""
    u = np.random.default_rng(seed).uniform(-1, 1, tuple(x.shape))
    return x * torch.from_numpy((1 + 2.0 ** -12 * u).astype(np.float32)).to(
        x.device)


#: B4 f32 runs 3xTF32 on the tensor cores: each product to ~2**-21
#: relative, f32 sums, so it holds the same 1e-5 * cond + 1e-6 as the
#: exact-product kernels (the reference's Precision.HIGHEST f32 tier).
@pytest.mark.parametrize("k", [8, 32])
@pytest.mark.parametrize("R,C", NATURAL_SHAPES)
@pytest.mark.parametrize("mode", ["split3", "bf16", "f32", "f32-full"])
def test_natural_kernels_match_plain(cuda, mode, R, C, k):
    csr = fem3d_csr(1024, 16000, seed=8).astype(np.float32)
    host = _u2(csr, R, C)
    wp = host.to(cuda)
    v = generate_fat_vector(1024, k, seed=R + C + k).astype(np.float32)
    v_p = wp.encode(torch.from_numpy(v).to(cuda)).contiguous()
    kernel, plain, tiles, dense, slabs = _natural_case(host, mode, v_p, cuda)
    cw.reset_launch_counts()
    got = kernel(wp.pair_block, wp.pair_chunk, wp.block_ptr, tiles, slabs,
                 nb=wp.n_blocks)
    name = "B3" if mode == "split3" else "B4"
    assert cw.launch_counts() == _counts(**{"B2": 0, name: 1})
    want = plain(wp.pair_block, wp.pair_chunk, dense, slabs, nb=wp.n_blocks)
    cond = plain(wp.pair_block, wp.pair_chunk, dense.abs(), slabs.abs(),
                 nb=wp.n_blocks)
    torch.cuda.synchronize()
    assert got.shape == (wp.n_blocks, R, k)
    _assert_b1_close(got, want, cond)


def test_natural_kernel_empty_run_writes_zeros(cuda):
    host = _u2(fem3d_csr(1024, 16000, seed=8).astype(np.float32), 64, 128)
    wp = host.to(cuda)
    v_p = wp.encode(torch.from_numpy(generate_fat_vector(
        1024, 8, seed=1).astype(np.float32)).to(cuda)).contiguous()
    kernel, _, tiles, _, slabs = _natural_case(host, "split3", v_p, cuda)
    bp = wp.block_ptr.clone()
    bp[1] = bp[0]  # block 0's run becomes empty
    out = kernel(wp.pair_block, wp.pair_chunk, bp, tiles, slabs,
                 nb=wp.n_blocks)
    assert torch.count_nonzero(out[0]) == 0 and torch.count_nonzero(out[1])


def test_odd_run_two_pair_operand_is_refused(cuda):
    host = WindowedPairs.from_csr(
        fem3d_csr(512, 8192, seed=2).astype(np.float32), block_rows=8,
        chunk_cols=128, reorder=None, pairs_per_step=4,
        beat_gather_margin=1e9, max_inflation=1e9)
    assert (np.diff(host.block_ptr) % 2).any()
    odd = dataclasses.replace(host, pairs_per_step=2, tiles_t=None)
    with pytest.raises(ValueError, match="two-pair kernel contract"):
        odd.to(cuda)
    wp = _u2(fem3d_csr(1024, 16000, seed=8).astype(np.float32), 64,
             128).to(cuda)
    slabs = torch.zeros((wp.n_chunks, 8, 256), dtype=torch.bfloat16,
                        device=cuda)
    with pytest.raises(ValueError, match="even pair count"):
        cw.windowed_matmul_split3(wp.pair_block[:-1], wp.pair_chunk[:-1],
                                  wp.block_ptr, wp.tiles_split[:-1], slabs,
                                  nb=wp.n_blocks)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        cw.windowed_matmul_single(
            wp.pair_block, wp.pair_chunk, wp.block_ptr,
            torch.zeros((wp.n_pairs, 64, 128), dtype=torch.float64,
                        device=cuda), slabs[..., :128].double(),
            nb=wp.n_blocks)


@pytest.mark.parametrize("k", [5, 12, 32])
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_two_pair_spmm_on_card_matches_oracle(cuda, dtype, k):
    """The whole U=2 route with a spill: B2 + B3 (f32) or B2 + B4 (bf16)
    for every k (5 zero-padded to 8, 12 to 16)."""
    csr = powerlaw_csr(2000, 2000, 20000, seed=7).astype(np.float32)
    if dtype == "bfloat16":
        csr = csr.astype(torch.bfloat16)
    wp = WindowedPairs.from_csr(csr, block_rows=128, chunk_cols=128,
                                pairs_per_step=2, beat_gather_margin=np.inf)
    assert wp is not None and wp.spill is not None
    wp = wp.to(cuda)
    # The card copy holds the natural compact plane its kernel reads.
    assert (wp.tiles is None) == (dtype == np.float32)
    assert isinstance(wp.tiles_split if dtype == np.float32 else wp.tiles,
                      CompactTiles)
    v = generate_fat_vector(2000, k, seed=k).astype(np.float32)
    vt = torch.from_numpy(v).to(cuda)
    if dtype == "bfloat16":
        vt = vt.to(torch.bfloat16)
    cw.reset_launch_counts()
    out = spmm_any(wp, vt)
    name = "B3" if dtype == np.float32 else "B4"
    assert cw.launch_counts() == _counts(**{"B2": 1, name: 1})
    ref = spmm_host_f64(csr, vt.cpu().float().numpy())
    err = np.abs(out.cpu().double().numpy() - ref).max() / np.abs(ref).max()
    assert err < (5e-3 if dtype == np.float32 else 5e-2)


def _natural_hazards(C, R, split, seed):
    """``_hazard_operand``'s tiles in the natural layout (P, R, planes *
    C), with tile 4's entries cut to output indices below R / 2, so at
    R = 256 the second CTA's slice of it is empty: blocks with empty runs,
    a tile with no entries (a padding pair), a fully dense tile (more
    than kCap entries in each CTA's rows), a full row, a -0.0 entry."""
    pb, pc, bp, tiles_t, nb, n_chunks = _hazard_operand(C, R, split, seed)
    tiles_t[4, :, R // 2:] = 0
    return pb, pc, bp, tiles_t.transpose(1, 2).contiguous(), nb, n_chunks


@pytest.mark.parametrize("split", [True, False], ids=["split3", "bf16"])
@pytest.mark.parametrize("k8", [8, 32, 64])
@pytest.mark.parametrize("C,R", [(128, 8), (128, 128), (256, 256),
                                 (512, 256), (512, 512)])
def test_natural_compact_hazards(cuda, C, R, k8, split):
    pb, pc, bp, tiles, nb, n_chunks = _natural_hazards(C, R, split,
                                                       seed=C + R + k8)
    ct = CompactTiles.from_natural(tiles, split)
    assert ct.natural and ct.shape == tuple(tiles.shape)
    assert ct.wide == (int(C * R > 65535) | int(C > 256) << 1)
    ct = ct.to(cuda)
    pb, pc, bp = (torch.from_numpy(a).to(cuda) for a in (pb, pc, bp))
    dense = tiles.to(cuda)
    assert torch.equal(ct.to_dense().view(torch.int16),
                       dense.view(torch.int16))
    v = torch.from_numpy(np.random.default_rng(k8).uniform(
        -50, 50, (n_chunks * C, k8)).astype(np.float32)).to(cuda)
    if split:
        kernel, plain = cw.windowed_matmul_split3, \
            cw.windowed_matmul_split3_plain
        slabs = cw.chunk_slabs(v, C=C, split=True)
    else:
        kernel, plain = cw.windowed_matmul_single, \
            cw.windowed_matmul_single_plain
        slabs = cw.chunk_slabs(v.to(torch.bfloat16), C=C, split=False)
    cw.reset_launch_counts()
    got = kernel(pb, pc, bp, ct, slabs, nb=nb)
    assert cw.launch_counts() == _counts(**{"B3" if split else "B4": 1})
    want = plain(pb, pc, dense, slabs, nb=nb)
    cond = plain(pb, pc, dense.abs(), slabs.abs(), nb=nb)
    torch.cuda.synchronize()
    assert got.shape == (nb, R, k8)
    _assert_b1_close(got, want, cond)
    assert torch.count_nonzero(got[1]) == torch.count_nonzero(got[4]) == 0


def test_two_pair_card_copies_hold_the_natural_plane(cuda):
    """``to`` keeps the natural compact plane in place of the dense one
    for U=2 f32 (``tiles_split``) and bf16 (``tiles``), and a dense plane
    on the card reaches no kernel."""
    csr = fem3d_csr(1024, 16000, seed=8).astype(np.float32)
    host = _u2(csr, 256, 256)
    hosts = {"f32": host, "bf16": host.astype(torch.bfloat16)}
    copies = {label: h.to(cuda) for label, h in hosts.items()}
    for label, h in hosts.items():
        wp = copies[label]
        field = "tiles_split" if label == "f32" else "tiles"
        ct = getattr(wp, field)
        assert isinstance(ct, CompactTiles) and ct.natural
        assert ct.device == cuda and ct.shape == getattr(h, field).shape
        assert wp.tiles_split is None if label == "bf16" else wp.tiles is None
        assert wp.dtype == (torch.float32 if label == "f32"
                            else torch.bfloat16)
        np.testing.assert_array_equal(
            ct.to_dense().cpu().view(torch.int16).numpy().view(np.uint16),
            getattr(h, field))
    wp = copies["f32"]
    dense = torch.from_numpy(host.tiles_split.view(np.int16)).to(cuda).view(
        torch.bfloat16)
    slabs = torch.zeros((wp.n_chunks, 8, 512), dtype=torch.bfloat16,
                        device=cuda)
    args = (wp.pair_block, wp.pair_chunk, wp.block_ptr)
    cw.reset_launch_counts()
    with pytest.raises(ValueError, match="dense natural plane"):
        cw.windowed_matmul_split3(*args, dense, slabs, nb=wp.n_blocks)
    with pytest.raises(ValueError, match="dense natural plane"):
        cw.windowed_matmul_single(*args, dense[..., :256].contiguous(),
                                  slabs[..., :256].contiguous(),
                                  nb=wp.n_blocks)
    # B1's orientation of the plane is refused too (R = C: same shape).
    with pytest.raises(ValueError, match="natural=False"):
        cw.windowed_matmul_single(
            *args, dataclasses.replace(copies["bf16"].tiles, natural=False),
            slabs[..., :256].contiguous(), nb=wp.n_blocks)
    assert cw.launch_counts() == _counts()


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_two_pair_past_the_compact_width_keeps_dense_planes(cuda, dtype):
    """C = 1024, past the widest chunk the compact kernel stages: the card
    copy keeps its dense natural planes, the dense kernel reads them, and
    the compact kernel refuses a compact plane of that width."""
    csr = fem3d_csr(2048, 32000, seed=3).astype(np.float32)
    if dtype == "bfloat16":
        csr = csr.astype(torch.bfloat16)
    host = _u2(csr, 256, 1024)
    wp = host.to(cuda)
    split = dtype == np.float32
    tiles = wp.natural_plane
    assert isinstance(tiles, torch.Tensor)
    v = generate_fat_vector(2048, 32, seed=4).astype(np.float32)
    v_p = wp.encode(torch.from_numpy(v).to(cuda)).contiguous()
    if split:
        kernel, plain = cw.windowed_matmul_split3, \
            cw.windowed_matmul_split3_plain
        slabs = cw.chunk_slabs(v_p, C=1024, split=True)
    else:
        kernel, plain = cw.windowed_matmul_single, \
            cw.windowed_matmul_single_plain
        slabs = cw.chunk_slabs(v_p.to(torch.bfloat16).contiguous(), C=1024,
                               split=False)
    args = (wp.pair_block, wp.pair_chunk, wp.block_ptr)
    cw.reset_launch_counts()
    got = kernel(*args, tiles, slabs, nb=wp.n_blocks)
    assert cw.launch_counts() == _counts(**{"B3" if split else "B4": 1})
    want = plain(wp.pair_block, wp.pair_chunk, tiles, slabs, nb=wp.n_blocks)
    cond = plain(wp.pair_block, wp.pair_chunk, tiles.abs(), slabs.abs(),
                 nb=wp.n_blocks)
    torch.cuda.synchronize()
    _assert_b1_close(got, want, cond)
    with pytest.raises(ValueError, match="C <= 512"):
        kernel(*args, CompactTiles.from_natural(tiles, split).to(cuda),
               slabs, nb=wp.n_blocks)
    out = spmm_any(wp, torch.from_numpy(v).to(cuda).to(
        torch.float32 if split else torch.bfloat16))
    assert _rel_to_oracle(out, csr, v) < (5e-3 if split else 5e-2)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_natural_nonfinite_v_reaches_only_its_entries(cuda, dtype):
    """B3 and B4 bf16 on the compact plane diverge from the reference as
    B1 does (ROADMAP C): an Inf or NaN in ``v`` makes non-finite exactly
    the rows a CSR product does, where the dense-tile plain version (and
    the TPU kernels) spread it over whole tiles."""
    csr = banded_csr(512, 24, 8, seed=4).astype(np.float32)
    if dtype == "bfloat16":
        csr = csr.astype(torch.bfloat16)
    wp = _u2(csr, 128, 128).to(cuda)
    v = generate_fat_vector(512, 16, seed=9).astype(np.float32)
    v[100, 3], v[300, 7], v[301, 7] = np.inf, np.nan, -np.inf
    vt = torch.from_numpy(v)
    if dtype == "bfloat16":
        vt = vt.to(torch.bfloat16)
    cw.reset_launch_counts()
    out = spmm_windowed(wp, vt.to(cuda)).cpu().float().numpy()
    assert cw.launch_counts() == _counts(
        B2=1, **{"B3" if dtype == np.float32 else "B4": 1})
    ref = _csr_product(csr.astype(np.float32), vt.float().numpy())
    bad = ~np.isfinite(ref)
    assert bad.any() and bad.sum() < bad.size
    np.testing.assert_array_equal(~np.isfinite(out), bad)
    err = np.abs(out[~bad] - ref[~bad]).max() / np.abs(ref[~bad]).max()
    assert err < (5e-3 if dtype == np.float32 else 5e-2)
    plain = spmm_windowed(wp.to("cpu"), vt).float().numpy()
    assert (~np.isfinite(plain)).sum() > bad.sum()


# ---- B6: the phased kernel ------------------------------------------------

def _phased(csr, *, multi):
    wp = WindowedPairs.from_csr(
        csr, block_rows=128, chunk_cols=128, reorder=None, pairs_per_step=8,
        beat_gather_margin=1e9, max_inflation=1e9, phase_layout=True)
    assert wp.phases is not None
    if multi:
        tiles_t, pb_ph, pc_ph, phases = _phase_fields(
            wp.tiles, wp.tiles_split, wp.pair_block, wp.pair_chunk,
            wp.n_blocks, wp.n_chunks, 2, 8)
        wp = dataclasses.replace(
            wp, tiles_t=tiles_t, pair_block_ph=pb_ph, pair_chunk_ph=pc_ph,
            phases=phases, chunks_per_phase=2,
            block_ptr_ph=_phase_block_ptr(pb_ph, phases))
        assert len(wp.phases) > 1
    return wp


@pytest.mark.parametrize("k", [8, 32])
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("multi", [False, True], ids=["one", "multi"])
@pytest.mark.parametrize("streamed", [False, True],
                         ids=["resident", "streamed"])
def test_phased_matches_plain(cuda, streamed, multi, dtype, k):
    csr = fem3d_csr(1024, 16384, seed=11).astype(np.float32)
    wp = _phased(csr, multi=multi)
    if dtype == "bfloat16":
        wp = wp.astype(torch.bfloat16)
    wp = wp.to(cuda)
    split = wp.split
    v = torch.from_numpy(generate_fat_vector(1024, k, seed=k).astype(
        np.float32)).to(cuda)
    v_p = wp.encode(v if split else v.to(torch.bfloat16)).contiguous()
    slabs = cw.chunk_slabs(v_p, C=128, split=split)
    args = (wp.pair_block_ph, wp.pair_chunk_ph, wp.block_ptr_ph, wp.tiles_t,
            slabs)
    kw = dict(nb=wp.n_blocks, phases=wp.phases, split=split)
    cw.reset_launch_counts()
    got = cw.windowed_matmul_tmulti_phased(
        *args, chunks_per_phase=wp.chunks_per_phase, pairs_per_step=8,
        force_streamed=streamed, **kw)
    expect = (_counts(B1=len(wp.phases)) if streamed
              else _counts(B6=1))
    assert cw.launch_counts() == expect
    dense = wp.tiles_t.to_dense()
    want = cw.windowed_matmul_tmulti_phased_plain(
        wp.pair_block_ph, wp.pair_chunk_ph, dense, slabs, **kw)
    cond = cw.windowed_matmul_tmulti_phased_plain(
        wp.pair_block_ph, wp.pair_chunk_ph, dense.abs(), slabs.abs(), **kw)
    torch.cuda.synchronize()
    _assert_b1_close(got, want, cond)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_phased_resident_equals_streamed_bitwise(cuda, dtype):
    """B6 and B1 per phase run one device function on one compact plane
    (slices of it per phase), so the two routes agree bit for bit."""
    wp = _phased(fem3d_csr(1024, 16384, seed=11).astype(np.float32),
                 multi=True)
    if dtype == "bfloat16":
        wp = wp.astype(torch.bfloat16)
    wp = wp.to(cuda)
    assert isinstance(wp.tiles_t, CompactTiles)
    v = torch.from_numpy(generate_fat_vector(1024, 32, seed=2).astype(
        np.float32)).to(cuda)
    v_p = wp.encode(v if wp.split else v.to(torch.bfloat16)).contiguous()
    slabs = cw.chunk_slabs(v_p, C=128, split=wp.split)
    args = (wp.pair_block_ph, wp.pair_chunk_ph, wp.block_ptr_ph, wp.tiles_t,
            slabs)
    kw = dict(nb=wp.n_blocks, phases=wp.phases, split=wp.split,
              chunks_per_phase=wp.chunks_per_phase, pairs_per_step=8)
    resident = cw.windowed_matmul_tmulti_phased(*args, **kw)
    streamed = cw.windowed_matmul_tmulti_phased(*args, force_streamed=True,
                                                **kw)
    assert torch.equal(resident, streamed)


def test_phased_routes_on_card_match_oracle(cuda):
    """One-shot SpMM and the transposed chain on a multi-phase operand:
    B2 + B6 per call, a narrow unaligned k zero-padded to 8 too."""
    csr = banded_csr(1024, 24, 8, seed=41).astype(np.float32)
    wp = _phased(csr, multi=True).to(cuda)
    assert wp.tiles is None and wp.supports_transposed_chain
    v = generate_fat_vector(1024, 16, seed=42).astype(np.float32)
    cw.reset_launch_counts()
    out = spmm_windowed(wp, torch.from_numpy(v).to(cuda))
    assert cw.launch_counts() == _counts(B2=1, B6=1)
    assert _rel_to_oracle(out, csr, v) < 5e-3
    enc, body, dec = windowed_t_chain(wp, 16)
    out = dec(body(body(enc(torch.from_numpy(v).to(cuda), wp), wp), wp), wp)
    ref = spmm_host_f64(csr, spmm_host_f64(csr, v))
    err = np.abs(out.cpu().double().numpy() - ref).max() / np.abs(ref).max()
    assert err < 5e-3
    assert cw.launch_counts() == _counts(B2=2, B6=3)
    v5 = generate_fat_vector(1024, 5, seed=43).astype(np.float32)
    out = spmm_windowed(wp, torch.from_numpy(v5).to(cuda))
    assert cw.launch_counts() == _counts(B2=3, B6=4)
    assert _rel_to_oracle(out, csr, v5) < 5e-3


# ---- B7: the spill's explicit-gather route --------------------------------

@pytest.mark.parametrize("k", [1, 8, 32, 100, 128])
@pytest.mark.parametrize("w", [1, 5, 40])
def test_ell_gather_matches_plain(cuda, w, k):
    rng = np.random.default_rng(w * 1000 + k)
    rows, n = 1000, 3000
    cols = torch.from_numpy(rng.integers(0, n, (rows, w)).astype(
        np.int32)).to(cuda)
    vals = torch.from_numpy(rng.normal(size=(rows, w)).astype(
        np.float32)).to(cuda)
    v = torch.from_numpy(rng.normal(scale=10.0, size=(n, k)).astype(
        np.float32)).to(cuda)
    cg.reset_launch_counts()
    got = cg.ell_gather_rows(cols, vals, v)
    assert cg.launch_counts() == {"B7": 1}
    want = cg.ell_gather_rows_plain(cols, vals, v)
    cond = cg.ell_gather_rows_plain(cols, vals.abs(), v.abs())
    torch.cuda.synchronize()
    _assert_b1_close(got, want, cond)
    with pytest.raises(ValueError, match="k <= 128"):
        cg.ell_gather_rows(cols, vals, torch.zeros((n, 129), device=cuda))


def _ell(rng, rows, w, n):
    cols = rng.integers(0, n, (rows, w)).astype(np.int32)
    vals = rng.normal(size=(rows, w)).astype(np.float32)
    return ELL(cols=cols, vals=vals, shape=(rows, n))


#: B7 sums each row's slots in lane groups, then adds the groups' partial
#: sums by shuffles: another order than the plain version's, so the
#: results agree within 1e-5 * cond + 1e-6, not bitwise.
@pytest.mark.parametrize("k", [1, 8, 32, 100, 128])
@pytest.mark.parametrize("w", [1, 5, 24, 40])
def test_ell_gather_bucketed_matches_plain(cuda, w, k):
    """One B7 launch over a bucket of width ``w``, an empty bucket, a
    one-row bucket and a narrow one, then the zero row; restored through
    a row map with rows that are in no bucket."""
    rng = np.random.default_rng(w * 1000 + k)
    n = 3000
    buckets = (_ell(rng, 1000, w, n), _ell(rng, 0, 3, n), _ell(rng, 1, 7, n),
               _ell(rng, 64, 2, n))
    stacked_rows = sum(b.m_padded for b in buckets)
    m = stacked_rows + 50
    inv = rng.permutation(m)
    inv[inv >= stacked_rows] = stacked_rows  # 50 rows in no bucket
    bell = BucketedELL(buckets=buckets, row_perm=np.zeros(0, np.int32),
                       inv_row_perm=inv.astype(np.int32), shape=(m, n)).to(
                           cuda)
    v = torch.from_numpy(rng.normal(scale=10.0, size=(n, k)).astype(
        np.float32)).to(cuda)
    cg.reset_launch_counts()
    got = cg.ell_gather_bucketed(bell, v)
    assert cg.launch_counts() == {"B7": 1}
    want = cg.ell_gather_bucketed_plain(bell, v)
    abs_bell = dataclasses.replace(bell, buckets=tuple(
        dataclasses.replace(b, vals=b.vals.abs()) for b in bell.buckets))
    cond = cg.ell_gather_bucketed_plain(abs_bell, v.abs())
    torch.cuda.synchronize()
    assert got.shape == (stacked_rows + 1, k)
    assert torch.count_nonzero(got[-1]) == 0
    _assert_b1_close(got, want, cond)
    idx = bell.inv_row_perm
    _assert_b1_close(got.index_select(0, idx), want.index_select(0, idx),
                     cond.index_select(0, idx))
    with pytest.raises(ValueError, match="at most 16 buckets"):
        cg.ell_gather_bucketed(
            dataclasses.replace(bell, buckets=bell.buckets * 5), v)


def test_spill_through_the_gather_kernel(cuda, monkeypatch):
    csr = powerlaw_csr(2000, 2000, 20000, seed=7).astype(np.float32)
    wp = WindowedPairs.from_csr(csr, block_rows=128, chunk_cols=128,
                                pairs_per_step=2, beat_gather_margin=np.inf)
    wp = wp.to(cuda)
    assert len(wp.spill.buckets) > 1
    v = generate_fat_vector(2000, 32, seed=3).astype(np.float32)
    vt = torch.from_numpy(v).to(cuda)
    take = spmm_any(wp, vt)
    monkeypatch.setattr(ell_ops, "SPILL_DMA_GATHER", True)
    cg.reset_launch_counts()
    dma = spmm_any(wp, vt)
    assert cg.launch_counts() == {"B7": 1}  # one launch per spill
    assert _rel_to_oracle(dma, csr, v) < 5e-3
    assert _rel_to_oracle(take, csr, v) < 5e-3
