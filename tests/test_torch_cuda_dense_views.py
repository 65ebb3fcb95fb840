"""Card-only tests of the dense views: ``to_dense`` of a ``.to("cuda")``
copy of every format, in f32 and bf16, against the host operand's, and
``spmm_dense`` on the card copy against the host f64 oracle.

A card copy of CSR, COO, ELL, BucketedELL, BandedBlocks and a bf16
windowed operand holds the host's values, so its dense view equals the
host's bit for bit. An f32 windowed copy at U = 16 (``R % 128 == 0``)
or U = 2 holds only the bf16 hi|lo planes its kernels read
(``WindowedPairs.card_planes``: the compact ``tiles_t``, the natural
compact plane, or the dense natural planes past ``COMPACT_MAX_C``): its
view equals, bit for bit, the host's view of the same planes, and is
within 2**-16 of each host value.

Every test skips without a CUDA device. The file imports no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda_dense_views.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from sparsematrixmultiplicationmpi_tpu_torch.formats import (
    BandedBlocks, BucketedELL, ELL,
)
from sparsematrixmultiplicationmpi_tpu_torch.formats import windowed as TW
from sparsematrixmultiplicationmpi_tpu_torch.formats.hub import (
    HubExtracted, split_hub_columns,
)
from sparsematrixmultiplicationmpi_tpu_torch.formats.windowed import (
    CompactTiles, WindowedPairs,
)
from sparsematrixmultiplicationmpi_tpu_torch.io.generate import (
    banded_csr, dc1_like, generate_fat_vector, powerlaw_csr,
)
from sparsematrixmultiplicationmpi_tpu_torch.ops.oracle import (
    spmm_dense, spmm_host_f64,
)

pytestmark = pytest.mark.gpu

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _same(got, want):
    assert isinstance(got, np.ndarray)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def _spmm_dense_on_card(op, csr, dev, dtype):
    """``spmm_dense`` of the card copy: ``v``'s dtype on ``v``'s device,
    within 1e-4 (f32: a split-only view is within 2**-16 of each value)
    or 2e-2 (bf16) of the f64 oracle, relative to its largest output."""
    v = generate_fat_vector(csr.shape[1], 4, seed=2).astype(np.float32)
    vt = torch.from_numpy(v).to(dev, DTYPES[dtype])
    out = spmm_dense(op, vt)
    assert out.dtype == vt.dtype and out.device == vt.device
    ref = spmm_host_f64(csr, vt.float().cpu().numpy())
    err = np.abs(out.float().cpu().numpy() - ref).max() / np.abs(ref).max()
    assert err < (1e-4 if dtype == "float32" else 2e-2), err


BASIC = {
    "CSR": lambda csr: csr,
    "COO": lambda csr: csr.to_coo(),
    "ELL": lambda csr: ELL.from_csr(csr),
    "BucketedELL": lambda csr: BucketedELL.from_csr(csr),
    "BandedBlocks": lambda csr: BandedBlocks.from_csr(csr, block_rows=8),
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("fmt", BASIC)
def test_card_copy_dense_view_is_the_hosts(cuda, fmt, dtype):
    csr = (banded_csr(400, 6, 4, seed=3) if fmt == "BandedBlocks"
           else powerlaw_csr(150, 150, 2500, seed=3)).astype(np.float32)
    csr = csr.astype(DTYPES[dtype])
    host = BASIC[fmt](csr)
    assert host is not None
    card = host.to(cuda)
    assert card.dtype == host.dtype == DTYPES[dtype]
    _same(card.to_dense(), host.to_dense())
    _spmm_dense_on_card(card, csr, cuda, dtype)


def _phased(host):
    """``host`` rebuilt with two chunks a phase (several phases)."""
    tiles_t, pb_ph, pc_ph, phases = TW._phase_fields(
        host.tiles, host.tiles_split, host.pair_block, host.pair_chunk,
        host.n_blocks, host.n_chunks, 2, host.pairs_per_step)
    assert len(phases) > 1
    return dataclasses.replace(
        host, tiles_t=tiles_t, pair_block_ph=pb_ph, pair_chunk_ph=pc_ph,
        phases=phases, chunks_per_phase=2,
        block_ptr_ph=TW._phase_block_ptr(pb_ph, phases))


WINDOWED = {  # (matrix, build arguments, the plane the card copy reads)
    "U16": (lambda: powerlaw_csr(2000, 2000, 20000, seed=7),
            dict(block_rows=128, chunk_cols=128, pairs_per_step=16,
                 beat_gather_margin=np.inf), "tiles_t"),
    "U2": (lambda: powerlaw_csr(2000, 2000, 20000, seed=7),
           dict(block_rows=128, chunk_cols=128, pairs_per_step=2,
                beat_gather_margin=np.inf), "natural"),
    "U2-C1024": (lambda: powerlaw_csr(2000, 2000, 20000, seed=7),
                 dict(block_rows=128, chunk_cols=1024, pairs_per_step=2,
                      beat_gather_margin=np.inf), None),
    "phased": (lambda: banded_csr(512, 24, 8, seed=51),
               dict(block_rows=128, chunk_cols=128, pairs_per_step=16,
                    reorder=None, beat_gather_margin=1e9, max_inflation=1e9,
                    phase_layout=True), "tiles_t"),
}


def _windowed(case, dtype):
    make, kw, _ = WINDOWED[case]
    csr = make().astype(np.float32)
    host = WindowedPairs.from_csr(csr, **kw)
    if case == "phased":
        host = _phased(host)
    return host.astype(DTYPES[dtype]), csr.astype(DTYPES[dtype])


def _check_windowed_view(card, host):
    """The card copy's view: the host's view of the same planes bit for
    bit; the host operand's bit for bit unless only split planes are
    held, then within 2**-16 of each value."""
    want = host.to_dense()
    same_planes = host.card_planes().to("cpu").to_dense()
    got = card.to_dense()
    _same(got, same_planes)
    if card.split and card.tiles is None:
        assert np.all(np.abs(got - want) <= 2.0 ** -16 * np.abs(want))
    else:
        _same(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", WINDOWED)
def test_card_copy_windowed_dense_view(cuda, case, dtype):
    host, csr = _windowed(case, dtype)
    card = host.to(cuda)
    plane = WINDOWED[case][2]
    held = card.tiles_t if plane == "tiles_t" else card.natural_plane
    assert isinstance(held, CompactTiles) == (plane is not None)
    if plane is not None:
        assert held.device.type == "cuda" and held.natural == (
            plane == "natural")
    assert card.dense_bytes == host.dense_bytes
    assert card.dtype == host.dtype == DTYPES[dtype]
    _check_windowed_view(card, host)
    _spmm_dense_on_card(card, csr, cuda, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_card_copy_hub_dense_view(cuda, dtype):
    csr = dc1_like(scale=0.02).astype(np.float32)
    ids, dense, rem = split_hub_columns(csr, threshold=csr.shape[0] // 20)
    rem_op = WindowedPairs.from_csr(rem, block_rows=128, chunk_cols=128,
                                    pairs_per_step=16,
                                    beat_gather_margin=np.inf)
    host = HubExtracted(dense_cols=dense, hub_ids=ids, remainder=rem_op,
                        shape=csr.shape).astype(DTYPES[dtype])
    card = host.to(cuda)
    assert isinstance(card.remainder.tiles_t, CompactTiles)
    want = dataclasses.replace(
        host, remainder=host.remainder.card_planes().to("cpu")).to_dense()
    _same(card.to_dense(), want)
    if dtype == "bfloat16":
        _same(card.to_dense(), host.to_dense())
    _spmm_dense_on_card(card, csr.astype(DTYPES[dtype]), cuda, dtype)
