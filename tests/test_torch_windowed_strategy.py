"""The port's row-sharded windowed strategy
(``parallel/windowed_strategy.py``) against the JAX package's.

``partition`` (host numpy) must equal the JAX ``prepare``'s sharded
arrays bit for bit at U = 2 and 16, in both input modes, on the
families of ``tests/test_windowed_strategy.py``. The multiplies (both
modes, ungathered, ``chain_parts``, the k-pad route) run on gloo groups
of p = 1, 2 and 4 spawned CPU ranks, against the oracle and the JAX
output on as many virtual devices."""

import numpy as np
import pytest
import torch

import sparsematrixmultiplicationmpi_tpu.io.generate as JG
import sparsematrixmultiplicationmpi_tpu_torch.io.generate as TG
from sparsematrixmultiplicationmpi_tpu.formats.matrix import CSR as JCSR
from sparsematrixmultiplicationmpi_tpu.parallel import make_mesh
from sparsematrixmultiplicationmpi_tpu.parallel.windowed_strategy import (
    WindowedRowWise as JWindowedRowWise,
)
from sparsematrixmultiplicationmpi_tpu_torch.formats.matrix import CSR
from sparsematrixmultiplicationmpi_tpu_torch.parallel import (
    WindowedRowWise, run_ranks,
)
from sparsematrixmultiplicationmpi_tpu_torch.parallel.windowed_strategy import (
    local_windowed, rank_window,
)

import _torch_dist_ranks as R
from _torch_jax_cases import check_case

C = R.case

#: (id, matrix, dtype, strategy kwargs): the families and options of
#: tests/test_windowed_strategy.py
PARTITIONS = [
    ("fem-R32-U16", "fem3000", None, dict(block_rows=32, chunk_cols=128)),
    ("fem-R32-U2-f32", "fem3000", np.float32,
     dict(block_rows=32, chunk_cols=128, pairs_per_step=2)),
    ("fem-R32-U8-f32", "fem3000", np.float32,
     dict(block_rows=32, chunk_cols=128, pairs_per_step=8)),
    ("fem-auto-shape", "fem1500", np.float32, {}),
    ("fem-auto-shape-U2", "fem1500", np.float32, dict(pairs_per_step=2)),
    ("fem2000-R32", "fem2000", None, dict(block_rows=32)),
    ("powerlaw-replicate", "powerlaw3000", None,
     dict(block_rows=16, chunk_cols=128)),
    ("powerlaw-forced-halo", "powerlaw2000", None,
     dict(block_rows=16, chunk_cols=128, input_mode="halo")),
    ("banded-no-reorder", "banded2048", None,
     dict(block_rows=32, chunk_cols=128, reorder=None)),
    ("rect-replicate", "rect", None,
     dict(block_rows=16, chunk_cols=128, input_mode="halo", reorder=None)),
]


def _bits(x):
    x = np.asarray(x)
    if x.dtype.itemsize == 2 and x.dtype.kind not in "iuf":
        return x.view(np.uint16)  # ml_dtypes bfloat16
    return x


def _same(a, b):
    a, b = _bits(a), np.ascontiguousarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(
        a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("p", [1, 2, 4, 8])
@pytest.mark.parametrize("name,mat,dtype,kw", PARTITIONS,
                         ids=[x[0] for x in PARTITIONS])
def test_partition_equals_jax_prepare_bit_for_bit(name, mat, dtype, kw, p):
    jcsr, csr = R.build(mat, JG, JCSR, dtype), R.build(mat, TG, CSR, dtype)
    jop = JWindowedRowWise(**kw).prepare(jcsr, make_mesh(p))
    shards = WindowedRowWise(**kw).partition(csr, p)
    assert len(shards) == p
    P_max = shards[0].pairs.n_pairs
    U = jop.pairs_per_step
    for d, op in enumerate(shards):
        pairs, s = op.pairs, op.s_loc
        pl = slice(d * P_max, (d + 1) * P_max)
        planes = pairs.tiles_t if U > 2 else pairs.tiles_split
        assert _same(np.asarray(jop.tiles)[pl], pairs.tiles)
        assert (jop.tiles_split is None) == (planes is None)
        if planes is not None:
            assert _same(np.asarray(jop.tiles_split)[pl], planes)
        assert _same(np.asarray(jop.pair_chunk)[pl], pairs.pair_chunk)
        assert _same(np.asarray(jop.pair_pos)[pl], pairs.pair_block)
        assert _same(np.asarray(jop.block_ptr)[d], pairs.block_ptr)
        for f in ("spill_cols", "spill_vals"):
            j = getattr(jop, f)
            assert (j is None) == (getattr(op, f) is None), f
            if j is not None:
                assert _same(np.asarray(j)[d * s:(d + 1) * s],
                             getattr(op, f)), f
        for f in ("tail_values", "tail_rows", "tail_cols"):
            j = getattr(jop, f)
            assert (j is None) == (getattr(op, f) is None), f
            if j is not None:
                t = len(j) // p
                assert _same(np.asarray(j)[d * t:(d + 1) * t],
                             getattr(op, f)), f
        for f in ("perm", "inv_perm"):
            j = getattr(jop, f)
            assert (j is None) == (getattr(op, f) is None)
            if j is not None:
                assert _same(j, getattr(op, f))
        assert (op.input_mode, op.halo_left, op.halo_right, op.s_loc,
                op.block_rows, op.chunk_cols, op.pairs_per_step) == (
            jop.input_mode, jop.halo_left, jop.halo_right, jop.s_loc,
            jop.block_rows, jop.chunk_cols, jop.pairs_per_step)


@pytest.mark.parametrize("U", [2, 8])
@pytest.mark.parametrize("p", [1, 4])
def test_partition_meets_the_kernel_pad_contract(p, U):
    """Per rank: every local block present, pairs block-ascending, runs
    even at U = 2, a multiple of U pairs, and ``block_ptr`` bounding the
    runs (the contract of the one-device kernels each rank runs)."""
    csr = R.build("fem3000", TG, CSR, np.float32)
    for op in WindowedRowWise(block_rows=32, chunk_cols=128,
                              pairs_per_step=U).partition(csr, p):
        pb = op.pairs.pair_block
        nb = op.pairs.n_blocks
        assert op.pairs.n_pairs % U == 0 and (np.diff(pb) >= 0).all()
        counts = np.bincount(pb, minlength=nb)
        assert (counts >= 1).all()
        if U == 2:
            assert (counts % 2 == 0).all()
            assert op.pairs.tiles_split is not None
        assert np.array_equal(np.diff(op.pairs.block_ptr), counts)


def test_halo_partition_has_multi_hop_windows():
    """Forced halo on hub structure at p = 4 needs windows of several
    ranks' chunks (h > ch_loc): the multi-hop permutes the spawned
    cases below run."""
    csr = R.build("powerlaw2000", TG, CSR)
    op = WindowedRowWise(block_rows=16, chunk_cols=128,
                         input_mode="halo").partition(csr, 4)[0]
    ch_loc = op.s_loc // op.chunk_cols
    assert op.input_mode == "halo" and max(op.halo_left,
                                           op.halo_right) > ch_loc


def test_local_windowed_is_the_one_device_contraction():
    """A rank's ``local_windowed`` on its window equals the plain
    product of its tiles (the einsum + segment-sum of the JAX body)."""
    csr = R.build("fem2000", TG, CSR)
    for op in WindowedRowWise(block_rows=32).partition(csr, 2):
        pairs = op.pairs
        v = torch.from_numpy(TG.generate_fat_vector(pairs.shape[1], 3,
                                                    seed=9))
        host = op.to("cpu")
        got = local_windowed(host, v)
        tiles = torch.from_numpy(pairs.tiles)
        slabs = v.reshape(-1, op.chunk_cols, 3)[torch.from_numpy(
            pairs.pair_chunk).long()]
        want = torch.zeros(pairs.n_blocks, op.block_rows, 3,
                           dtype=torch.float64).index_add_(
            0, torch.from_numpy(pairs.pair_block).long(),
            torch.bmm(tiles, slabs)).reshape(-1, 3)
        assert got.shape == (op.s_loc, 3)
        assert torch.allclose(got, want, rtol=0, atol=1e-12)


W = dict(block_rows=32, chunk_cols=128)


def _cases(p):
    cases = [C(f"fem-k{k}", "fem3000", "windowed_row", k, kwargs=W,
               seed=202) for k in (1, 5)]
    cases += [
        C("ungathered", "fem2000", "windowed_row", 3,
          kwargs=dict(block_rows=32), seed=204, gather=False),
        C("chain-compose", "fem2000", "windowed_row", 2,
          kwargs=dict(block_rows=32), seed=206, mode="chain2"),
        C("chain-sharded", "fem2000", "windowed_row", 2,
          kwargs=dict(block_rows=32), seed=218, mode="chain2",
          gather=False),
        C("powerlaw", "powerlaw3000", "windowed_row", 4,
          kwargs=dict(block_rows=16, chunk_cols=128), seed=208),
        C("banded-no-reorder", "banded2048", "windowed_row", 6,
          kwargs=dict(block_rows=32, reorder=None), seed=210),
        C("forced-halo-hubs", "powerlaw2000", "windowed_row", 3,
          kwargs=dict(block_rows=16, chunk_cols=128, input_mode="halo"),
          seed=241),
        C("rectangular", "rect", "windowed_row", 2,
          kwargs=dict(block_rows=16, chunk_cols=128, input_mode="halo",
                      reorder=None), seed=243),
    ]
    for U in (2, 8):
        cases += [
            C(f"f32-U{U}-k8", "fem1500", "windowed_row", 8, dtype="float32",
              kwargs=dict(W, pairs_per_step=U), seed=214),
            C(f"f32-U{U}-kpad12", "fem1500", "windowed_row", 12,
              dtype="float32", kwargs=dict(W, pairs_per_step=U), seed=218),
        ]
    cases.append(C("f32-unaligned-k3", "fem1500", "windowed_row", 3,
                   dtype="float32", kwargs=W, seed=216))
    cases.append(C("auto", "fem1500", "auto", 4, seed=212))
    cases.append(C("auto-chain", "fem1500", "auto", 4, seed=212,
                   mode="chain1"))
    return cases


CASES = {p: _cases(p) for p in (1, 2, 4)}
#: each rank's halo window, as the ranks exchange it (p = 2 and 4)
WINDOWS = [C("window-fem", "fem3000", "windowed_row", 3, kwargs=W, seed=5,
             mode="window"),
           C("window-hubs", "powerlaw2000", "windowed_row", 3,
             kwargs=dict(block_rows=16, chunk_cols=128, input_mode="halo"),
             seed=6, mode="window")]


@pytest.fixture(scope="module")
def ranks():
    return {p: run_ranks(R.run_cases, p, CASES[p] + (
        WINDOWS if p > 1 else []), device="cpu", timeout=600)
        for p in CASES}


@pytest.mark.parametrize("p,c", [(p, c) for p in CASES for c in CASES[p]],
                         ids=lambda x: x["id"] if isinstance(x, dict)
                         else f"p{x}")
def test_windowed_row_matches_oracle_and_jax(p, c, ranks):
    check_case(c, p, ranks[p])


def test_input_modes_match_jax(ranks):
    """Halo on the FEM families, replicate on hubs and on the
    rectangular matrix, at every p; the mesh-routed Auto picks the
    windowed strategy on FEM structure at p > 1."""
    for p in (2, 4):
        r = ranks[p][0]
        assert r["fem-k5"]["input_mode"] == "halo"
        assert r["powerlaw"]["input_mode"] == "replicate"
        assert r["forced-halo-hubs"]["input_mode"] == "halo"
        assert r["rectangular"]["input_mode"] == "replicate"
        assert r["auto"]["operand"] == "WindowedRowOperand"


@pytest.mark.parametrize("p", [2, 4])
def test_halo_window_is_the_host_cut(p, ranks):
    """Each rank's window from the permutes (multi-hop on the hub
    matrix) is ``rank_window``'s cut of the whole padded vector, the
    window the card's per-rank phase feeds one rank at a time."""
    for c in WINDOWS:
        csr = R.build(c["matrix"], TG, CSR)
        shards = WindowedRowWise(**c["kwargs"]).partition(csr, p)
        v = torch.from_numpy(TG.generate_fat_vector(csr.shape[1], c["k"],
                                                    seed=c["seed"]))
        v_pad = torch.zeros((p * shards[0].s_loc, c["k"]),
                            dtype=torch.float64)
        v_pad[: csr.shape[0]] = v[torch.from_numpy(shards[0].perm).long()]
        for d in range(p):
            got = torch.from_numpy(ranks[p][d][c["id"]]["out"])
            assert torch.equal(got, rank_window(shards[d], v_pad, d)), (
                c["id"], d)
