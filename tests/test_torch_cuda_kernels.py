"""Card-only tests of the port's CUDA kernels (B1, B2) against their plain
PyTorch versions and the host f64 oracle.

Every test here needs an NVIDIA GPU and ``nvcc``; elsewhere each one
skips from inside the ``cuda`` fixture. The file imports no JAX, so it
runs on a machine without it:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from sparsematrixmultiplicationmpi_tpu_torch.formats.windowed import (
    WindowedPairs,
)
from sparsematrixmultiplicationmpi_tpu_torch.io.generate import (
    banded_csr, fem3d_csr, generate_fat_vector,
)
from sparsematrixmultiplicationmpi_tpu_torch.ops import cuda_windowed as cw
from sparsematrixmultiplicationmpi_tpu_torch.ops.oracle import spmm_host_f64
from sparsematrixmultiplicationmpi_tpu_torch.ops.windowed import (
    _finish, spmm_windowed, windowed_t_chain,
)

pytestmark = pytest.mark.gpu

#: B1 against its plain version: both sum exact bf16 x bf16 products in
#: f32, in another order; |diff| <= RTOL * cond + ATOL with cond the
#: plain B1 on the planes' absolute values.
RTOL, ATOL = 1e-5, 1e-6


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


def _slabs(wp, k, dev, seed):
    v = generate_fat_vector(wp.shape[1], k, seed=seed).astype(np.float32)
    v_p = wp.encode(torch.from_numpy(v).to(dev)).contiguous()
    return v, v_p, cw.chunk_slabs(v_p, C=wp.chunk_cols, split=True)


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
    wp = _wp(csr, U=U, R=16).to(cuda)
    _, _, slabs = _slabs(wp, 16, cuda, seed=1)
    got = cw.windowed_matmul_tmulti(
        wp.pair_block, wp.pair_chunk, wp.block_ptr, wp.tiles_t, slabs,
        nb=wp.n_blocks, pairs_per_step=U)
    want = cw.windowed_matmul_tmulti_plain(
        wp.pair_block, wp.pair_chunk, wp.tiles_t, slabs, nb=wp.n_blocks)
    cond = cw.windowed_matmul_tmulti_plain(
        wp.pair_block, wp.pair_chunk, wp.tiles_t.abs(), slabs.abs(),
        nb=wp.n_blocks)
    _assert_b1_close(got, want, cond)
    # The fused epilogue is the exact bf16 split of the same f32 sum.
    fused = cw.windowed_matmul_tmulti(
        wp.pair_block, wp.pair_chunk, wp.block_ptr, wp.tiles_t, slabs,
        nb=wp.n_blocks, pairs_per_step=U, fuse_resplit=True)
    assert torch.equal(fused.view(torch.int16),
                       cw.resplit_slabs(got).view(torch.int16))


def test_tmulti_spans_blocks_mid_step(cuda):
    csr = fem3d_csr(512, 8192, seed=2).astype(np.float32)
    wp = _wp(csr, U=8, R=8)
    assert (np.diff(wp.block_ptr) % 8 != 0).any()
    wp = wp.to(cuda)
    v, v_p, slabs = _slabs(wp, 16, cuda, seed=3)
    got = cw.windowed_matmul_tmulti(
        wp.pair_block, wp.pair_chunk, wp.block_ptr, wp.tiles_t, slabs,
        nb=wp.n_blocks, pairs_per_step=8)
    computed = got.transpose(1, 2).reshape(wp.n_blocks * 8, 16)
    out = wp.decode(_finish(wp, computed, v_p))  # + the spill, if any
    ref = spmm_host_f64(csr, v)
    err = np.abs(out.cpu().double().numpy() - ref).max() / np.abs(ref).max()
    assert err < 5e-3


def test_tmulti_empty_run_writes_zeros(cuda):
    csr = fem3d_csr(256, 4096, seed=0).astype(np.float32)
    wp = _wp(csr, U=8, R=16).to(cuda)
    _, _, slabs = _slabs(wp, 16, cuda, seed=4)
    bp = wp.block_ptr.clone()
    bp[1] = bp[0]  # block 0's run becomes empty
    out = cw.windowed_matmul_tmulti(
        wp.pair_block, wp.pair_chunk, bp, wp.tiles_t, slabs,
        nb=wp.n_blocks, pairs_per_step=8)
    assert torch.count_nonzero(out[0]) == 0


def test_kernels_count_launches(cuda):
    csr = fem3d_csr(256, 4096, seed=0).astype(np.float32)
    wp = _wp(csr, U=8, R=16).to(cuda)
    cw.reset_launch_counts()
    _, _, slabs = _slabs(wp, 16, cuda, seed=5)
    cw.windowed_matmul_tmulti(
        wp.pair_block, wp.pair_chunk, wp.block_ptr, wp.tiles_t, slabs,
        nb=wp.n_blocks, pairs_per_step=8)
    assert cw.launch_counts() == {"B1": 1, "B2": 1}


def test_card_copy_holds_only_what_its_route_reads(cuda):
    csr = banded_csr(512, 24, 8, seed=4).astype(np.float32)
    host = _wp(csr, U=8, R=128)
    wp = host.to(cuda)
    assert wp.tiles is None and wp.tiles_split is None
    assert wp.tiles_t.is_cuda and wp.split and wp.n_pairs == host.n_pairs
    # R % 128 != 0: the card runs the plain path on the natural planes.
    r16 = _wp(fem3d_csr(256, 4096, seed=0).astype(np.float32), U=8,
              R=16).to(cuda)
    assert r16.tiles is not None and r16.tiles_split is not None
    # Narrow unaligned k takes the plain path, on tiles rebuilt from tiles_t.
    v = generate_fat_vector(512, 5, seed=7).astype(np.float32)
    cw.reset_launch_counts()
    out = spmm_windowed(wp, torch.from_numpy(v).to(cuda))
    assert cw.launch_counts() == {"B1": 0, "B2": 0}
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
    assert cw.launch_counts() == {"B1": 1, "B2": 1}
    ref = spmm_host_f64(csr, v)
    err = np.abs(out.cpu().double().numpy() - ref).max() / np.abs(ref).max()
    assert err < 5e-3
    one_shot = spmm_windowed(wp, torch.from_numpy(v).to(cuda))
    err = np.abs(one_shot.cpu().double().numpy() - ref).max() / \
        np.abs(ref).max()
    assert err < 5e-3
