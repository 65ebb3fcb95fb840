"""Card-only tests of narrow unaligned k (k = 1, 3) on the kernels: on a
CUDA tensor such k is zero-padded to 8 and runs B2 + B1 (U > 2) or
B2 + B3 / B4 (U = 2) where the reference took its dense plain route.
Each kernel against its plain version at k8 = 8, each route's launches
and its result against the host f64 oracle, the transposed chain at
k = 1, and PageRank (k = 1) on a small cop20k stand-in: one B2 and one
B1 an iteration, ranks against a host float64 power iteration. The
models benchmark at ``--scale 0.05``, where the H100 table prices
PageRank's graph to COO (no hand-written kernel: none may launch), and
at ``--scale 0.5``, where it takes bucketed ELL (one B7 an iteration).

Every test skips without a CUDA device. The file imports no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda_narrow_k.py
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from sparsematrixmultiplicationmpi_tpu_torch.formats.matrix import to_tensor
from sparsematrixmultiplicationmpi_tpu_torch.formats.windowed import (
    CompactTiles, WindowedPairs,
)
from sparsematrixmultiplicationmpi_tpu_torch.io.generate import (
    banded_csr, cop20k_like, generate_fat_vector, powerlaw_csr,
)
from sparsematrixmultiplicationmpi_tpu_torch.models import (
    normalize_columns, pagerank,
)
from sparsematrixmultiplicationmpi_tpu_torch.ops import cuda_windowed as cw
from sparsematrixmultiplicationmpi_tpu_torch.ops.auto import (
    auto_format, spmm_any,
)
from sparsematrixmultiplicationmpi_tpu_torch.ops.oracle import spmm_host_f64
from sparsematrixmultiplicationmpi_tpu_torch.ops.windowed import (
    windowed_t_chain,
)
from sparsematrixmultiplicationmpi_tpu_torch.scripts import run_models_bench

pytestmark = pytest.mark.gpu

#: Kernel against plain version on the same slabs: |diff| <= RTOL * cond
#: + ATOL, cond the plain version on the absolute values.
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _counts(**nonzero):
    return {**dict.fromkeys(("B1", "B2", "B3", "B4", "B6"), 0), **nonzero}


def _close(got, want, cond):
    diff = (got.float() - want.float()).abs()
    assert bool((diff <= RTOL * cond + ATOL).all()), float(diff.max())


def _rel_to_oracle(out, csr, v):
    ref = spmm_host_f64(csr, v.cpu().float().numpy())
    return np.abs(out.cpu().double().numpy() - ref).max() / np.abs(ref).max()


def _padded(wp, v, k8=8):
    v_p = wp.encode(v)
    return torch.cat([v_p, v_p.new_zeros((v_p.shape[0], k8 - v.shape[1]))],
                     dim=1).contiguous()


@pytest.mark.parametrize("k", [1, 3])
def test_narrow_k_through_b1(cuda, k):
    csr = banded_csr(512, 24, 8, seed=4).astype(np.float32)
    host = WindowedPairs.from_csr(
        csr, block_rows=128, chunk_cols=128, pairs_per_step=16,
        reorder=None, beat_gather_margin=1e9, max_inflation=1e9)
    wp = host.to(cuda)
    assert isinstance(wp.tiles_t, CompactTiles)
    v = torch.from_numpy(generate_fat_vector(512, k, seed=k).astype(
        np.float32)).to(cuda)
    slabs = cw.chunk_slabs(_padded(wp, v), C=128, split=True)
    assert slabs.shape[1] == 8
    kw = dict(nb=wp.n_blocks, split=True)
    cw.reset_launch_counts()
    got = cw.windowed_matmul_tmulti(wp.pair_block, wp.pair_chunk,
                                    wp.block_ptr, wp.tiles_t, slabs,
                                    pairs_per_step=16, **kw)
    assert cw.launch_counts() == _counts(B1=1)
    dense = to_tensor(host.tiles_t, cuda)
    want = cw.windowed_matmul_tmulti_plain(wp.pair_block, wp.pair_chunk,
                                           dense, slabs, **kw)
    cond = cw.windowed_matmul_tmulti_plain(wp.pair_block, wp.pair_chunk,
                                           dense.abs(), slabs.abs(), **kw)
    torch.cuda.synchronize()
    _close(got, want, cond)
    assert not bool(got[:, k:].any())  # the zero pad stays zero

    cw.reset_launch_counts()
    out = spmm_any(wp, v)
    assert cw.launch_counts() == _counts(B1=1, B2=1)
    assert out.shape == (512, k) and _rel_to_oracle(out, csr, v) < 5e-3
    enc, body, dec = windowed_t_chain(wp, k)
    cw.reset_launch_counts()
    two = dec(body(body(enc(v, wp), wp), wp), wp)
    assert cw.launch_counts() == _counts(B1=2, B2=1)
    ref = spmm_host_f64(csr, spmm_host_f64(csr, v.cpu().numpy()))
    err = np.abs(two.cpu().double().numpy() - ref).max() / np.abs(ref).max()
    assert two.shape == (512, k) and err < 5e-3


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_narrow_k_through_b3_b4(cuda, dtype, k):
    csr = powerlaw_csr(2000, 2000, 20000, seed=7).astype(np.float32)
    if dtype == "bfloat16":
        csr = csr.astype(torch.bfloat16)
    host = WindowedPairs.from_csr(csr, block_rows=128, chunk_cols=128,
                                  pairs_per_step=2, beat_gather_margin=np.inf)
    assert host.spill is not None
    wp = host.to(cuda)
    plane = wp.natural_plane
    assert isinstance(plane, CompactTiles) and plane.natural
    v = torch.from_numpy(generate_fat_vector(2000, k, seed=k).astype(
        np.float32)).to(cuda)
    split = dtype == "float32"
    v_in = v if split else v.to(torch.bfloat16)
    v8 = _padded(wp, v_in)
    slabs = cw.chunk_slabs(v8, C=128, split=split)
    kernel, plain, name = (
        (cw.windowed_matmul_split3, cw.windowed_matmul_split3_plain, "B3")
        if split else
        (cw.windowed_matmul_single, cw.windowed_matmul_single_plain, "B4"))
    args = (wp.pair_block, wp.pair_chunk)
    cw.reset_launch_counts()
    got = kernel(*args, wp.block_ptr, plane, slabs, nb=wp.n_blocks)
    assert cw.launch_counts() == _counts(**{name: 1})
    dense = to_tensor(host.natural_plane, cuda)
    want = plain(*args, dense, slabs, nb=wp.n_blocks)
    cond = plain(*args, dense.abs(), slabs.abs(), nb=wp.n_blocks)
    torch.cuda.synchronize()
    _close(got, want, cond)

    cw.reset_launch_counts()
    out = spmm_any(wp, v_in)
    assert cw.launch_counts() == _counts(**{"B2": 1, name: 1})
    assert out.shape == (2000, k)
    assert _rel_to_oracle(out, csr, v_in) < (5e-3 if split else 5e-2)


def test_pagerank_runs_b2_and_b1_each_iteration(cuda):
    g = cop20k_like(scale=0.05, seed=4)
    g = dataclasses.replace(g, values=np.abs(g.values))
    norm = normalize_columns(g).astype(np.float32)
    host = auto_format(norm, k_nominal=1)
    assert isinstance(host, WindowedPairs) and host.pairs_per_step == 16
    op = host.to(cuda)
    cw.reset_launch_counts()
    r, it = pagerank(lambda v: spmm_any(op, v), norm.shape[0], tol=1e-7,
                     max_iter=100, dtype=torch.float32, device=cuda)
    assert it > 5 and cw.launch_counts() == _counts(B1=it, B2=it)
    ref = run_models_bench.pagerank_host_f64(norm, it)
    got = r.cpu().double().numpy()
    assert np.max(np.abs(got - ref) / ref) <= 5e-3
    assert abs(float(r.sum()) - 1.0) <= 1e-4


def test_models_bench_on_the_card_small(cuda, tmp_path):
    assert run_models_bench.main([
        "--out-dir", str(tmp_path), "--scale", "0.05"]) == 0
    assert (tmp_path / "models_h100.json").exists()


def test_models_bench_on_the_card_at_a_kernel_route(cuda, tmp_path,
                                                    capsys):
    """At half size PageRank's graph takes bucketed ELL: the script holds
    its B7 launches to one multiply's an iteration."""
    assert run_models_bench.main([
        "--out-dir", str(tmp_path), "--scale", "0.5"]) == 0
    checked = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    route = checked["checks"]["pagerank_route"]
    assert route == {"format": "BucketedELL", "kernels": ["B7"]}, route
    assert checked["checks"]["pagerank_one_multiply_per_iteration"] is True
    assert checked["launches"]["pagerank"]["B7"] > 0
