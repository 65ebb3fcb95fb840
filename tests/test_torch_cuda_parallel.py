"""Card-only tests of the distributed layer: every strategy on a
one-rank NCCL group against the oracle, with the windowed strategy's
kernel launches per multiply; and the kernels B1 / B3 / B4 on each rank
operand of a p = 4 partition against their plain versions.

Every test needs an NVIDIA GPU and ``nvcc`` and skips from inside the
``cuda`` fixture elsewhere. The file imports no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda_parallel.py
"""

import numpy as np
import pytest
import torch

import sparsematrixmultiplicationmpi_tpu_torch.io.generate as TG
from sparsematrixmultiplicationmpi_tpu_torch.formats.matrix import (
    CSR, to_tensor,
)
from sparsematrixmultiplicationmpi_tpu_torch.formats.windowed import (
    CompactTiles,
)
from sparsematrixmultiplicationmpi_tpu_torch.ops import cuda_windowed as cw
from sparsematrixmultiplicationmpi_tpu_torch.ops.oracle import spmm_host_f64
from sparsematrixmultiplicationmpi_tpu_torch.parallel import (
    WindowedRowWise, run_ranks,
)
from sparsematrixmultiplicationmpi_tpu_torch.parallel.windowed_strategy \
    import rank_rows, rank_window
from sparsematrixmultiplicationmpi_tpu_torch.utils.compare import (
    are_matrices_equal, default_tolerance,
)

import _torch_dist_ranks as R

pytestmark = pytest.mark.gpu

#: A kernel against its plain version: |diff| <= RTOL * cond + ATOL, cond
#: the plain version on the operands' absolute values.
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


C = R.case
W16 = dict(block_rows=128, chunk_cols=128)
CARD_CASES = [
    C(f"{_id}-{g}", mat, name, 32, kwargs=kw, dtype=dt, gather=g,
      seed=3)
    for _id, mat, name, kw, dt in (
        ("row", "fem20k", "row", {}, "float32"),
        ("column", "fem20k", "column", {}, "float32"),
        ("nnz", "fem20k", "nnz", {}, "float32"),
        ("nnz-scatter", "fem20k", "nnz", {"reduce": "scatter"}, "float32"),
        ("library", "fem20k", "library", {}, "float32"),
        ("auto", "fem20k", "auto", {}, "float32"),
        ("windowed-U16", "fem20k", "windowed_row", W16, "float32"),
        ("windowed-U2", "fem20k", "windowed_row",
         dict(W16, pairs_per_step=2), "float32"),
        ("windowed-U2-bf16", "fem20k", "windowed_row",
         dict(W16, pairs_per_step=2), "bfloat16"),
        ("banded", "spd_band", "banded_row", {}, "float32"))
    for g in (True, False)]
CARD_CASES += [C(f"grid-{g}", "fem20k", "grid2d", 32, dtype="float32",
                 gather=g, mesh2d=(1, 1), seed=3) for g in (True, False)]
#: kernel launches a windowed multiply makes, by case
LAUNCHES = {"windowed-U16": {"B1": 1, "B2": 1},
            "windowed-U2": {"B2": 1, "B3": 1},
            "windowed-U2-bf16": {"B2": 1, "B4": 1}}


def test_every_strategy_on_one_nccl_rank(cuda):
    """Each strategy through a one-rank NCCL group on the card, result
    gathered and not, against the f64 oracle in its dtype's tier; the
    windowed strategy launches exactly its kernels once a multiply."""
    res = run_ranks(R.run_cases, 1, CARD_CASES, device="cuda",
                    timeout=900)[0]
    for c in CARD_CASES:
        dt = getattr(torch, c["dtype"])
        csr = R.build(c["matrix"], TG, CSR, dt)
        v = TG.generate_fat_vector(csr.shape[1], 32, seed=3)
        v = torch.from_numpy(v).to(dt).double().numpy()
        want = spmm_host_f64(csr, v)
        r = res[c["id"]]
        tol = default_tolerance(dt)
        scale = max(float(np.abs(want).max()), 1.0)
        if dt == torch.bfloat16:
            assert float(np.abs(r["full"] - want).max()) / scale < 5e-2
        else:
            assert are_matrices_equal(r["full"], want, tolerance=tol,
                                      relative=True), c["id"]
        for name, want_n in LAUNCHES.get(c["id"].rsplit("-", 1)[0],
                                         {}).items():
            assert r["launches"][name] == want_n, (c["id"], r["launches"])


@pytest.mark.parametrize("U,dtype", [(16, torch.float32),
                                     (2, torch.float32),
                                     (2, torch.bfloat16)])
def test_rank_kernels_of_a_p4_partition(cuda, U, dtype):
    """Every rank of a halo-mode p = 4 partition: its card copy holds the
    compact plane of its host plane bit for bit; B2 on its window is
    bitwise its plain version; B1 (U = 16), B3 (U = 2 f32) or B4 (U = 2
    bf16) on its pairs within 1e-5 * cond + 1e-6 of the plain version on
    the host's dense plane; and the four row blocks, decoded, are the
    oracle."""
    csr = R.build("fem20k", TG, CSR, dtype)
    shards = WindowedRowWise(pairs_per_step=U, **W16).partition(csr, 4)
    assert shards[0].input_mode == "halo"
    v = torch.from_numpy(TG.generate_fat_vector(csr.shape[1], 32, seed=5))
    v = v.to(dtype).to(cuda)
    S = 4 * shards[0].s_loc
    v_pad = torch.zeros((S, 32), dtype=dtype, device=cuda)
    perm = torch.from_numpy(shards[0].perm).long().to(cuda)
    v_pad[: csr.shape[0]] = v[perm]
    split = dtype == torch.float32
    rows = []
    for d, host in enumerate(shards):
        op = host.to(cuda)
        hp, cp = host.pairs, op.pairs
        plane_host = hp.tiles_t if U > 2 else hp.natural_plane
        plane = cp.tiles_t if U > 2 else cp.natural_plane
        assert isinstance(plane, CompactTiles)
        dense = to_tensor(plane_host, cuda)
        assert torch.equal(plane.to_dense().view(torch.int16),
                           dense.view(torch.int16))
        window = rank_window(host, v_pad, d)
        slabs = cw.chunk_slabs(window.to(torch.float32) if split else window,
                               C=host.chunk_cols, split=split)
        plain_slabs = cw.chunk_slabs_plain(
            window.to(torch.float32) if split else window,
            C=host.chunk_cols, split=split)
        assert torch.equal(slabs.view(torch.int16),
                           plain_slabs.view(torch.int16))
        nb = cp.n_blocks
        if U > 2:
            got = cw.windowed_matmul_tmulti(
                cp.pair_block, cp.pair_chunk, cp.block_ptr, plane, slabs,
                nb=nb, pairs_per_step=U, split=True)

            def plain(t, s):
                return cw.windowed_matmul_tmulti_plain(
                    cp.pair_block, cp.pair_chunk, t, s, nb=nb, split=True)
        elif split:
            got = cw.windowed_matmul_split3(cp.pair_block, cp.pair_chunk,
                                            cp.block_ptr, plane, slabs,
                                            nb=nb)

            def plain(t, s):
                return cw.windowed_matmul_split3_plain(
                    cp.pair_block, cp.pair_chunk, t, s, nb=nb)
        else:
            got = cw.windowed_matmul_single(cp.pair_block, cp.pair_chunk,
                                            cp.block_ptr, plane, slabs,
                                            nb=nb)

            def plain(t, s):
                return cw.windowed_matmul_single_plain(
                    cp.pair_block, cp.pair_chunk, t, s, nb=nb)
        want = plain(dense, plain_slabs)
        cond = plain(dense.abs(), plain_slabs.abs())
        assert bool(((got - want).abs() <= RTOL * cond + ATOL).all()), d
        rows.append(rank_rows(op, window))
    out = shards[0].to(cuda).decode(torch.cat(rows))
    want = spmm_host_f64(csr, v.double().cpu().numpy())
    tier = default_tolerance(dtype)
    if split:
        assert are_matrices_equal(out.double().cpu().numpy(), want,
                                  tolerance=tier, relative=True)
    else:
        scale = max(float(np.abs(want).max()), 1.0)
        assert float(np.abs(out.double().cpu().numpy() - want).max()) \
            / scale < 5e-2
