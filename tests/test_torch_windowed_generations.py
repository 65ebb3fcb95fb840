"""The port's other windowed kernel generations on the CPU, held against
the JAX package: the two-pair (U=2) kernels B3 (split3) and B4 (one
plane), the phased kernel B6 with its host layout, the spill's explicit
gather B7, and the bf16 path through the port's entry points.

* Host-side layouts (``build_phase_layout``, ``_chunks_per_phase``, the
  phase-layout build, ``astype``) must be bit-identical.
* Each plain version is held against the JAX kernel in interpret mode on
  the same operand. Both sides sum exact products (bf16 x bf16, or f32
  products for f32 tiles) in f32 in another order, so ``|diff| <= 1e-5 *
  cond + 1e-6`` with ``cond`` the same contraction over absolute values.
* Whole SpMMs and chains are held to the dtype tier of
  ``utils/compare.py`` (5e-3 relative to the largest output for f32,
  5e-2 for bf16) against the JAX package and the host f64 oracle.
* B7's one launch per spill (``ell_gather_bucketed``) is held against the
  JAX package's per-bucket DMA route, and B4 f32's 3xTF32 products,
  emulated, against the f64 product, where there is no card.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sparsematrixmultiplicationmpi_tpu.formats.matrix as JM
import sparsematrixmultiplicationmpi_tpu.formats.windowed as JW
import sparsematrixmultiplicationmpi_tpu.io.generate as JG
import sparsematrixmultiplicationmpi_tpu.ops.auto as JA
import sparsematrixmultiplicationmpi_tpu.ops.ell as JE
import sparsematrixmultiplicationmpi_tpu.ops.pallas_windowed as JP
import sparsematrixmultiplicationmpi_tpu.ops.windowed as JOW
from sparsematrixmultiplicationmpi_tpu.bench.harness import (
    run_benchmark as jax_run_benchmark,
)
from sparsematrixmultiplicationmpi_tpu.formats.matrix import ELL as JELL
from sparsematrixmultiplicationmpi_tpu.ops.oracle import (
    spmm_host_f64 as jax_oracle,
)
from sparsematrixmultiplicationmpi_tpu.ops.pallas_gather import (
    ell_gather_rows_pallas,
)
from sparsematrixmultiplicationmpi_tpu.parallel import Auto as JAuto
from sparsematrixmultiplicationmpi_tpu.parallel import make_mesh
import sparsematrixmultiplicationmpi_tpu_torch.formats.matrix as TM
import sparsematrixmultiplicationmpi_tpu_torch.formats.windowed as TW
import sparsematrixmultiplicationmpi_tpu_torch.io.generate as TG
import sparsematrixmultiplicationmpi_tpu_torch.ops.auto as TA
import sparsematrixmultiplicationmpi_tpu_torch.ops.ell as TE
from sparsematrixmultiplicationmpi_tpu_torch.bench.harness import (
    run_benchmark,
)
from sparsematrixmultiplicationmpi_tpu_torch.formats.matrix import (
    ELL, as_float64,
)
from sparsematrixmultiplicationmpi_tpu_torch.ops import cuda_gather as cg
from sparsematrixmultiplicationmpi_tpu_torch.ops import cuda_windowed as cw
from sparsematrixmultiplicationmpi_tpu_torch.ops import windowed as TOW
from sparsematrixmultiplicationmpi_tpu_torch.ops.oracle import spmm_host_f64
from sparsematrixmultiplicationmpi_tpu_torch.parallel import Auto
from sparsematrixmultiplicationmpi_tpu_torch.utils.compare import (
    default_tolerance,
)

RTOL, ATOL = 1e-5, 1e-6
TIER = {np.float32: 5e-3, "bfloat16": 5e-2}
PINNED = dict(chunk_cols=128, reorder=None, beat_gather_margin=1e9,
              max_inflation=1e9)


def _bits(x):
    """Host array as comparable bits: bf16 (ml_dtypes or uint16) as
    uint16, anything else as it is."""
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.itemsize == 2 else x


def _tbits(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _csrs(make, dtype):
    """The JAX and the port CSR of one generator call in ``dtype``
    (np.float32 or "bfloat16")."""
    jt, tt = ((jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16"
              else (dtype, dtype))
    return make(JG).astype(jt), make(TG).astype(tt)


def _port(jw):
    """The identical port operand (host arrays) of a JAX operand."""
    fields = {f.name: getattr(jw, f.name) for f in dataclasses.fields(jw)}
    return TW.WindowedPairs.from_arrays(**fields)


def _multi_phase(jw, cpp=2):
    """A JAX operand rebuilt with ``cpp`` chunks per phase (several
    phases on a small matrix), as ``tests/test_phased.py`` does."""
    tiles_t, pb_ph, pc_ph, phases = JW._phase_fields(
        np.asarray(jw.tiles),
        None if jw.tiles_split is None else np.asarray(jw.tiles_split),
        jw.pair_block, jw.pair_chunk, jw.n_blocks, jw.n_chunks, cpp,
        jw.pairs_per_step)
    out = dataclasses.replace(jw, tiles_t=tiles_t, pair_block_ph=pb_ph,
                              pair_chunk_ph=pc_ph, phases=phases,
                              chunks_per_phase=cpp)
    assert len(out.phases) > 1
    return out


def _assert_phase_fields_equal(jw, tw):
    for f in ("tiles", "tiles_split", "tiles_t", "pair_block", "pair_chunk",
              "block_ptr", "pair_block_ph", "pair_chunk_ph"):
        a, b = getattr(jw, f), getattr(tw, f)
        assert (a is None) == (b is None), f
        if a is not None:
            a = _bits(a)
            assert a.dtype == b.dtype and a.shape == b.shape, f
            np.testing.assert_array_equal(a, b, err_msg=f)
    assert jw.phases == tw.phases
    assert jw.chunks_per_phase == tw.chunks_per_phase
    assert (jw.spill is None) == (tw.spill is None)
    if jw.spill is not None:
        for x, y in zip(jw.spill.buckets, tw.spill.buckets):
            np.testing.assert_array_equal(_bits(x.vals), y.vals)
            np.testing.assert_array_equal(np.asarray(x.cols), y.cols)


def _close(got, want, cond):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    excess = np.abs(got - want) - (RTOL * np.asarray(cond) + ATOL)
    assert excess.max() <= 0, float(np.abs(got - want).max())


def _rel(a, b):
    return float(np.abs(np.asarray(a, np.float64) - b).max()
                 / np.abs(b).max())


def _fat(n, k, seed, dtype=np.float32):
    v = JG.generate_fat_vector(n, k, seed=seed)
    if dtype == "bfloat16":
        return v.astype(jnp.bfloat16), torch.from_numpy(
            v.astype(np.float32)).to(torch.bfloat16)
    return v.astype(dtype), torch.from_numpy(v.astype(dtype))


# ---- host layout: bit parity -------------------------------------------

@pytest.mark.parametrize("seed,nb,n_chunks,cpp,U", [
    (0, 11, 10, 3, 4), (1, 40, 40, 7, 16), (2, 5, 64, 16, 8),
    (3, 30, 9, 1, 2)])
def test_build_phase_layout_bit_identical(seed, nb, n_chunks, cpp, U):
    rng = np.random.default_rng(seed)
    P = 4 * nb
    pb = np.sort(rng.integers(0, nb, P)).astype(np.int32)
    pc = rng.integers(0, n_chunks, P).astype(np.int32)
    want = JW.build_phase_layout(pb, pc, nb, n_chunks, cpp, U)
    got = TW.build_phase_layout(pb, pc, nb, n_chunks, cpp, U)
    for a, b in zip(want[:3], got[:3]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert want[3] == got[3]
    # The work list: each phase's run bounds, relative to its first pair.
    bp = TW._phase_block_ptr(got[0], got[3])
    o = 0
    for off, n, _, _, nb_ph in got[3]:
        runs = bp[o:o + nb_ph + 1]
        assert runs[0] == 0 and runs[-1] == n
        lb = got[0][off:off + n]
        for b in range(nb_ph):
            assert (lb[runs[b]:runs[b + 1]] == b).all()
        o += nb_ph + 1
    assert o == len(bp)


@pytest.mark.parametrize("C", [128, 256, 512])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_chunks_per_phase_matches(C, itemsize):
    for k in (1, 8, 12, 32, 128, 4096):
        assert TW._chunks_per_phase(C, itemsize, k) == \
            JW._chunks_per_phase(C, itemsize, k)
    assert TW.RESIDENT_SLAB_VMEM_BYTES == JW.RESIDENT_SLAB_VMEM_BYTES


PHASED = {
    "banded-U16": (lambda g: g.banded_csr(512, 24, 8, seed=4),
                   dict(block_rows=128, pairs_per_step=16, **PINNED)),
    "fem3d-U8": (lambda g: g.fem3d_csr(1024, 16384, seed=11),
                 dict(block_rows=128, pairs_per_step=8, **PINNED)),
    "powerlaw-spill": (lambda g: g.powerlaw_csr(2048, 2048, 30000, seed=31),
                       dict(block_rows=128, chunk_cols=128, reorder=None,
                            pairs_per_step=8, beat_gather_margin=1e9)),
    "cop20k-square": (lambda g: g.cop20k_like(scale=0.03),
                      dict(block_rows=128, chunk_cols=128)),
}


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("name", sorted(PHASED))
def test_phase_layout_build_bit_identical(name, dtype):
    make, kw = PHASED[name]
    jc, tc = _csrs(make, dtype)
    jw = JW.WindowedPairs.from_csr(jc, phase_layout=True, **kw)
    tw = TW.WindowedPairs.from_csr(tc, phase_layout=True, **kw)
    assert jw.phases is not None
    _assert_phase_fields_equal(jw, tw)
    np.testing.assert_array_equal(
        tw.block_ptr_ph, TW._phase_block_ptr(tw.pair_block_ph, tw.phases))
    # The port also takes the JAX operand's fields as they are.
    _assert_phase_fields_equal(jw, _port(jw))


@pytest.mark.parametrize("to", ["bfloat16", np.float32])
@pytest.mark.parametrize("layout", ["block-major", "one-phase",
                                    "multi-phase", "U2-spill"])
def test_astype_bit_identical(layout, to):
    if layout == "U2-spill":
        jw = JW.WindowedPairs.from_csr(
            JG.powerlaw_csr(2000, 2000, 20000, seed=7).astype(np.float32),
            block_rows=128, chunk_cols=128, pairs_per_step=2,
            beat_gather_margin=np.inf)
        assert jw.spill is not None
    else:
        jw = JW.WindowedPairs.from_csr(
            JG.banded_csr(512, 24, 8, seed=51).astype(np.float32),
            block_rows=128, pairs_per_step=16,
            phase_layout=layout != "block-major", **PINNED)
        if layout == "multi-phase":
            jw = _multi_phase(jw)
    tw = _port(jw)
    jt, tt = ((jnp.bfloat16, torch.bfloat16) if to == "bfloat16"
              else (np.float32, np.float32))
    jb, tb = jw.astype(jt), tw.astype(tt)
    _assert_phase_fields_equal(jb, tb)
    assert tb.dtype == (torch.bfloat16 if to == "bfloat16"
                        else torch.float32)
    # ... and back: bf16 -> f32 re-derives the split planes.
    _assert_phase_fields_equal(jb.astype(np.float32),
                               tb.astype(np.float32))


# ---- plain versions against the JAX kernels in interpret mode ----------

def _u2_case(dtype, R=16, seed=0):
    jc, _ = _csrs(lambda g: g.fem3d_csr(256, 4096, seed=seed), dtype)
    jw = JW.WindowedPairs.from_csr(jc, block_rows=R, pairs_per_step=2,
                                   **PINNED)
    return jw, _port(jw).to("cpu")


@pytest.mark.parametrize("k", [8, 16])
def test_split3_plain_vs_jax_interpret(k):
    jw, tw = _u2_case(np.float32)
    assert tw.n_pairs % 2 == 0 and tw.tiles_split is not None
    jv, tv = _fat(256, k, seed=1)
    want = JP.windowed_matmul_split3(
        jw.pair_block, jw.pair_chunk, jnp.asarray(jw.tiles_split),
        jw.encode(jnp.asarray(jv)), nb=jw.n_blocks, interpret=True)
    slabs = cw.chunk_slabs(tw.encode(tv).contiguous(), C=128, split=True)
    got = cw.windowed_matmul_split3(tw.pair_block, tw.pair_chunk,
                                    tw.block_ptr, tw.tiles_split, slabs,
                                    nb=tw.n_blocks)
    cond = cw.windowed_matmul_split3_plain(
        tw.pair_block, tw.pair_chunk, tw.tiles_split.abs(), slabs.abs(),
        nb=tw.n_blocks)
    assert got.shape == (tw.n_blocks, 16, k) and got.dtype == torch.float32
    _close(got.numpy(), np.asarray(want), cond.numpy())
    # On the natural compact plane (what a card copy holds) the plain
    # version densifies it: the same bits.
    ct = TW.CompactTiles.from_natural(tw.tiles_split, True).to("cpu")
    assert torch.equal(cw.windowed_matmul_split3(
        tw.pair_block, tw.pair_chunk, tw.block_ptr, ct, slabs,
        nb=tw.n_blocks), got)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_single_plane_plain_vs_jax_interpret(dtype):
    jw, tw = _u2_case(dtype)
    jv, tv = _fat(256, 16, seed=2, dtype=dtype)
    want = JP.windowed_matmul_pallas(
        jw.pair_block, jw.pair_chunk, jnp.asarray(jw.tiles),
        jw.encode(jnp.asarray(jv)), nb=jw.n_blocks, interpret=True)
    slabs = cw.chunk_slabs(tw.encode(tv).to(tw.tiles.dtype).contiguous(),
                           C=128, split=False)
    got = cw.windowed_matmul_single(tw.pair_block, tw.pair_chunk,
                                    tw.block_ptr, tw.tiles, slabs,
                                    nb=tw.n_blocks)
    cond = cw.windowed_matmul_single_plain(
        tw.pair_block, tw.pair_chunk, tw.tiles.abs(), slabs.abs(),
        nb=tw.n_blocks)
    assert got.dtype == torch.float32
    _close(got.numpy(), np.asarray(want), cond.numpy())
    if dtype == "bfloat16":  # the natural compact plane B4 bf16 reads
        ct = TW.CompactTiles.from_natural(tw.tiles, False).to("cpu")
        assert torch.equal(cw.windowed_matmul_single(
            tw.pair_block, tw.pair_chunk, tw.block_ptr, ct, slabs,
            nb=tw.n_blocks), got)


def test_two_pair_contract_checks():
    _, tw = _u2_case(np.float32)
    slabs = cw.chunk_slabs(tw.encode(_fat(256, 8, 3)[1]).contiguous(),
                           C=128, split=True)
    odd = slice(0, tw.n_pairs - 1)
    with pytest.raises(ValueError, match="even pair count"):
        cw.windowed_matmul_split3(tw.pair_block[odd], tw.pair_chunk[odd],
                                  tw.block_ptr, tw.tiles_split[odd], slabs,
                                  nb=tw.n_blocks)
    with pytest.raises(ValueError, match="even pair count"):
        cw.windowed_matmul_single(tw.pair_block[odd], tw.pair_chunk[odd],
                                  tw.block_ptr, tw.tiles[odd],
                                  slabs[..., :128], nb=tw.n_blocks)
    with pytest.raises(ValueError, match="slab width"):
        cw.windowed_matmul_split3(tw.pair_block, tw.pair_chunk, tw.block_ptr,
                                  tw.tiles_split, slabs[..., :128],
                                  nb=tw.n_blocks)


def _phased_case(kind, dtype=np.float32):
    jc, _ = _csrs(lambda g: g.fem3d_csr(1024, 16384, seed=11), dtype)
    if kind == "single":
        jc, _ = _csrs(lambda g: g.banded_csr(512, 24, 8, seed=4), dtype)
    jw = JW.WindowedPairs.from_csr(jc, block_rows=128, pairs_per_step=8,
                                   phase_layout=True, **PINNED)
    if kind != "single":
        jw = _multi_phase(jw)
    return jw, _port(jw).to("cpu")


@pytest.mark.parametrize("kind,streamed", [
    ("single", False), ("multi", False), ("multi", True)])
def test_phased_plain_vs_jax_interpret(kind, streamed):
    jw, tw = _phased_case(kind)
    n = tw.shape[1]
    jv, tv = _fat(n, 16, seed=4)
    (jslabs,) = JP.chunk_slabs(jw.encode(jnp.asarray(jv)), C=128,
                               split=True, interpret=True)
    want = JP.windowed_matmul_tmulti_phased(
        jw.pair_block_ph, jw.pair_chunk_ph, jnp.asarray(jw.tiles_t), jslabs,
        nb=jw.n_blocks, phases=jw.phases,
        chunks_per_phase=jw.chunks_per_phase, pairs_per_step=8,
        split=True, interpret=True, force_streamed=streamed)
    slabs = cw.chunk_slabs(tw.encode(tv).contiguous(), C=128, split=True)
    kw = dict(nb=tw.n_blocks, phases=tw.phases, split=True)
    got = cw.windowed_matmul_tmulti_phased(
        tw.pair_block_ph, tw.pair_chunk_ph, tw.block_ptr_ph, tw.tiles_t,
        slabs, chunks_per_phase=tw.chunks_per_phase, pairs_per_step=8,
        force_streamed=streamed, **kw)
    cond = cw.windowed_matmul_tmulti_phased_plain(
        tw.pair_block_ph, tw.pair_chunk_ph, tw.tiles_t.abs(), slabs.abs(),
        **kw)
    _close(got.numpy(), np.asarray(want), cond.numpy())
    # The block-major B1 plain version on the same operand agrees too.
    blk = cw.windowed_matmul_tmulti_plain(
        tw.pair_block, tw.pair_chunk,
        tw.tiles_split.transpose(1, 2).contiguous(), slabs, nb=tw.n_blocks)
    _close(got.numpy(), blk.numpy(), cond.numpy())


def test_phased_contract_checks():
    _, tw = _phased_case("multi")
    slabs = cw.chunk_slabs(tw.encode(_fat(1024, 8, 5)[1]).contiguous(),
                           C=128, split=True)
    kw = dict(nb=tw.n_blocks, phases=tw.phases,
              chunks_per_phase=tw.chunks_per_phase, pairs_per_step=8)
    args = (tw.pair_block_ph, tw.pair_chunk_ph, tw.block_ptr_ph)
    with pytest.raises(ValueError, match="slab width"):
        cw.windowed_matmul_tmulti_phased(*args, tw.tiles_t,
                                         slabs[..., :128].contiguous(), **kw)
    with pytest.raises(ValueError, match="requires bf16 operands"):
        cw.windowed_matmul_tmulti_phased(*args, tw.tiles_t.float(), slabs,
                                         split=False, **kw)


@pytest.mark.parametrize("k", [1, 8, 32, 100])
def test_ell_gather_plain_vs_jax_interpret(k):
    rng = np.random.default_rng(k)
    rows, w, n = 16, 5, 40
    cols = rng.integers(0, n, (rows, w)).astype(np.int32)
    vals = rng.normal(size=(rows, w)).astype(np.float32)
    vals[3, 2:] = 0.0  # padding slots
    v = rng.normal(scale=10.0, size=(n, k)).astype(np.float32)
    v128 = np.zeros((n, 128), np.float32)
    v128[:, :k] = v
    want = np.asarray(ell_gather_rows_pallas(
        jnp.asarray(cols), jnp.asarray(vals), jnp.asarray(v128),
        rows_per_step=8, interpret=True))[:, :k]
    tc, tv = torch.from_numpy(cols), torch.from_numpy(v)
    got = cg.ell_gather_rows(tc, torch.from_numpy(vals), tv)
    cond = cg.ell_gather_rows_plain(tc, torch.from_numpy(np.abs(vals)),
                                    tv.abs())
    assert got.shape == (rows, k) and got.dtype == torch.float32
    _close(got.numpy(), want, cond.numpy())
    with pytest.raises(ValueError, match="k <= 128"):
        cg.ell_gather_rows(tc, torch.from_numpy(vals),
                           torch.zeros((n, 129)))


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_spmm_ell_dma_route_vs_jax(dtype, monkeypatch):
    jc, tc = _csrs(lambda g: g.random_csr(300, 200, 2000, seed=6), dtype)
    jell, tell = JELL.from_csr(jc, width_align=2), ELL.from_csr(
        tc, width_align=2)
    tell = tell.to("cpu")
    jv, tv = _fat(200, 24, seed=7, dtype=dtype)
    want = np.asarray(JE.spmm_ell(jell, jnp.asarray(jv), dma_gather=True),
                      np.float64)
    got = TE.spmm_ell(tell, tv, dma_gather=True)
    take = TE.spmm_ell(tell, tv, dma_gather=False)
    assert got.dtype == take.dtype == tv.dtype
    assert got.shape == take.shape == (300, 24)
    ref = spmm_host_f64(tc, as_float64(_tbits(tv)))
    tier = TIER[dtype]
    for out in (got, take):
        out = out.double().numpy()
        assert _rel(out, ref) < tier and _rel(out, want) < tier
    # The switch: off by default, and read at each call.
    assert TE.SPILL_DMA_GATHER is False
    cg.reset_launch_counts()
    seen = []
    real = TE._spmm_ell_dma
    monkeypatch.setattr(TE, "_spmm_ell_dma",
                        lambda e, v: seen.append(1) or real(e, v))
    TE.spmm_ell(tell, tv)
    assert seen == []
    monkeypatch.setattr(TE, "SPILL_DMA_GATHER", True)
    TE.spmm_ell(tell, tv)
    TE.spmm_ell(tell, torch.zeros((200, 129), dtype=tv.dtype))  # k > 128
    assert seen == [1]
    assert cg.launch_counts() == {"B7": 0}  # CPU tensors: plain version
    with pytest.raises(ValueError, match="k <= 128"):
        TE.spmm_ell(tell, torch.zeros((200, 129)), dma_gather=True)


#: The families of ``tests/test_torch_foundation.py``'s bucketed builders,
#: smaller: the JAX DMA kernel unrolls its row copies, so interpret mode
#: takes seconds per bucket, more for wide ones. The powerlaw matrix has
#: empty rows (in no bucket).
FAMILIES = {
    "fem3d": lambda g: g.fem3d_csr(64, 500, seed=12),
    "powerlaw": lambda g: g.powerlaw_csr(20, 20, 60, seed=13),
    "random": lambda g: g.random_csr(120, 100, 800, seed=14),
    "banded": lambda g: g.banded_csr(150, 20, 7, seed=15),
}


def _abs_bucketed(bell):
    return dataclasses.replace(bell, buckets=tuple(
        dataclasses.replace(b, vals=b.vals.abs()) for b in bell.buckets))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_ell_gather_bucketed_plain_vs_jax_dma_route(family, monkeypatch):
    """The one-launch B7 layout (every bucket stacked, then the zero row),
    restored through ``inv_row_perm``, against the JAX package's
    ``spmm_bucketed`` on its DMA-gather route (the Pallas kernel per
    bucket, interpret mode). The kernel sums slots in another order than
    the reference: ``1e-5 * cond + 1e-6``."""
    jc, tc = _csrs(FAMILIES[family], np.float32)
    jb, tb = JM.BucketedELL.from_csr(jc), TM.BucketedELL.from_csr(tc)
    tb = tb.to("cpu")
    n = tc.shape[1]
    jv, tv = _fat(n, 24, seed=13)
    monkeypatch.setattr(JE, "SPILL_DMA_GATHER", True)
    want = np.asarray(JE.spmm_bucketed(jb, jnp.asarray(jv)))
    stacked = cg.ell_gather_bucketed(tb, tv)
    assert stacked.shape == (sum(b.m_padded for b in tb.buckets) + 1, 24)
    assert not stacked[-1].any()
    got = stacked.index_select(0, tb.inv_row_perm)
    cond = cg.ell_gather_bucketed_plain(_abs_bucketed(tb), tv.abs())
    cond = cond.index_select(0, tb.inv_row_perm)
    _close(got.numpy(), want, cond.numpy())
    # The route switch: the same stacked table on the take route.
    monkeypatch.setattr(TE, "SPILL_DMA_GATHER", True)
    _close(TE.spmm_bucketed(tb, tv).numpy(), want, cond.numpy())
    monkeypatch.setattr(TE, "SPILL_DMA_GATHER", False)
    _close(TE.spmm_bucketed(tb, tv).numpy(), want, cond.numpy())


def test_ell_gather_bucketed_contract():
    tc = TG.random_csr(64, 50, 400, seed=15).astype(np.float32)
    tb = TM.BucketedELL.from_csr(tc).to("cpu")
    v = torch.ones((50, 8))
    many = dataclasses.replace(tb, buckets=tb.buckets[:1] * 17)
    with pytest.raises(ValueError, match="at most 16 buckets"):
        cg.ell_gather_bucketed(many, v)
    with pytest.raises(ValueError, match="k <= 128"):
        cg.ell_gather_bucketed(tb, torch.ones((50, 129)))
    cg.reset_launch_counts()
    cg.ell_gather_bucketed(dataclasses.replace(tb, buckets=tb.buckets[:1]
                                               * 16), v)
    assert cg.launch_counts() == {"B7": 0}  # CPU tensors: plain version


def test_ell_gather_bucketed_segment_table():
    """The one-launch kernel's host table: one row per bucket (pointers,
    W, rows, first stacked row) and the zero row, built once per operand
    and dropped with it."""
    tc = TG.fem3d_csr(64, 500, seed=12).astype(np.float32)
    tb = TM.BucketedELL.from_csr(tc).to("cpu")
    cpu = torch.device("cpu")
    table, rows = cg._segment_table(tb, cpu)
    assert rows == sum(b.m_padded for b in tb.buckets)
    first = np.cumsum([0] + [b.m_padded for b in tb.buckets])
    for row, b, f in zip(table, tb.buckets, first):
        assert tuple(row) == (b.cols.data_ptr(), b.vals.data_ptr(), b.width,
                              b.m_padded, f)
    assert tuple(table[-1]) == (0, 0, 0, 1, rows)
    assert cg._segment_table(tb, cpu)[0] is table
    with pytest.raises(ValueError, match="buckets are on cpu"):
        cg._segment_table(tb, torch.device("cuda", 0))
    key = id(tb)
    del tb
    assert key not in cg._segment_tables


def test_finish_on_the_b7_route_vs_jax(monkeypatch):
    """``_finish`` restores a U=2 spill through one B7 launch's stacked
    table (plain version here) where the JAX package runs its DMA kernel
    per bucket and concatenates: the same padded-space result."""
    k = 16
    # Five spill buckets of W <= 20 (the JAX DMA kernel's interpret mode
    # does not get through a bucket hundreds of slots wide).
    kw = dict(block_rows=32, chunk_cols=128, pairs_per_step=2,
              beat_gather_margin=np.inf)
    jc, tc = _csrs(lambda g: g.random_csr(300, 300, 3000, seed=7),
                   np.float32)
    jw = JW.WindowedPairs.from_csr(jc, **kw)
    tw = TW.WindowedPairs.from_csr(tc, **kw).to("cpu")
    assert tw.spill is not None and len(tw.spill.buckets) > 1
    jv, tv = _fat(tc.shape[1], k, seed=14)
    jv_p, tv_p = jw.encode(jnp.asarray(jv)), tw.encode(tv)
    blocks = np.random.default_rng(k).normal(
        size=(tw.n_blocks * tw.block_rows, k)).astype(np.float32)
    monkeypatch.setattr(JE, "SPILL_DMA_GATHER", True)
    want = np.asarray(JOW._finish(jw, jnp.asarray(blocks), jv_p))
    monkeypatch.setattr(TE, "SPILL_DMA_GATHER", True)
    got = TOW._finish(tw, torch.from_numpy(blocks), tv_p)
    assert got.shape == want.shape == (tw.pad_rows, k)
    abs_w = dataclasses.replace(tw, spill=_abs_bucketed(tw.spill))
    cond = TOW._finish(abs_w, torch.from_numpy(np.abs(blocks)), tv_p.abs())
    _close(got.numpy(), want, cond.numpy())


# ---- B4 f32's 3xTF32 products, emulated ----------------------------------

#: Every (R, C) of the card tests' ``NATURAL_SHAPES``.
NATURAL_SHAPES = [(8, 128), (64, 128), (64, 256), (256, 128), (256, 256),
                  (256, 512), (512, 512)]


def _rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value (10 mantissa bits), ties away from
    zero: ``cvt.rna.tf32.f32``. Adding half an ulp to the magnitude bits
    of a sign-magnitude float and truncating rounds half away."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_products(tiles, slabs, pair_block, pair_chunk, nb, *, passes):
    """B4 f32's contraction with TF32 operands: ``passes=3`` is the
    kernel's 3xTF32 (big.big + big.small + small.big, big = rna(x),
    small = rna(x - big)), ``passes=1`` one TF32 product. TF32 x TF32
    products are exact in f32; the sums are f32."""
    sl = slabs.index_select(0, pair_chunk)
    tb, sb = _rna_tf32(tiles), _rna_tf32(sl)
    prods = torch.bmm(tb, sb.transpose(1, 2))
    if passes == 3:
        ts, ss = _rna_tf32(tiles - tb), _rna_tf32(sl - sb)
        prods = (prods + torch.bmm(tb, ss.transpose(1, 2))
                 + torch.bmm(ts, sb.transpose(1, 2)))
    out = prods.new_zeros((nb,) + tuple(prods.shape[1:]))
    return out.index_add_(0, pair_block, prods)


def test_rna_tf32_rounds_to_ten_bits_ties_away():
    one = 1.0
    ulp = 2.0 ** -10
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2 ** -23,
                      one + 3 * ulp / 2, 3.0, 0.0], dtype=torch.float32)
    want = [one + ulp, -(one + ulp), one, one + 2 * ulp, 3.0, 0.0]
    assert _rna_tf32(x).tolist() == want


@pytest.mark.parametrize("k", [8, 32])
@pytest.mark.parametrize("R,C", NATURAL_SHAPES)
def test_3xtf32_products_hold_the_f32_tier(R, C, k):
    """The precision argument of B4 f32 on the tensor cores, where there
    is no card: on full-mantissa tiles and slabs the 3xTF32 contraction
    stays within ``1e-5 * cond + 1e-6`` of the f64 product, and a single
    TF32 product does not."""
    csr = TG.fem3d_csr(1024, 16000, seed=8).astype(np.float32)
    wp = TW.WindowedPairs.from_csr(
        csr, block_rows=R, chunk_cols=C, reorder=None, pairs_per_step=2,
        beat_gather_margin=1e9, max_inflation=1e9,
        allow_spill=False).to("cpu")
    rng = np.random.default_rng(R + C + k)
    full = lambda x: x * torch.from_numpy(  # noqa: E731
        (1 + 2.0 ** -12 * rng.uniform(-1, 1, x.shape)).astype(np.float32))
    tiles = full(wp.tiles)
    v = TG.generate_fat_vector(1024, k, seed=R + C + k).astype(np.float32)
    slabs = full(cw.chunk_slabs(wp.encode(torch.from_numpy(v)).contiguous(),
                                C=C, split=False))
    assert (tiles != _rna_tf32(tiles)).any() and (
        slabs != _rna_tf32(slabs)).any()
    args = (wp.pair_block, wp.pair_chunk)
    exact = cw.windowed_matmul_single_plain(
        *args, tiles.double(), slabs.double(), nb=wp.n_blocks)
    cond = cw.windowed_matmul_single_plain(
        *args, tiles.double().abs(), slabs.double().abs(), nb=wp.n_blocks)
    bound = RTOL * cond + ATOL
    three = _tf32_products(tiles, slabs, *args, wp.n_blocks, passes=3)
    assert bool(((three.double() - exact).abs() <= bound).all())
    one = _tf32_products(tiles, slabs, *args, wp.n_blocks, passes=1)
    assert not bool(((one.double() - exact).abs() <= bound).all())


# ---- the bf16 path through the entry points ----------------------------

def test_bf16_astype_gives_the_jax_bits():
    jc = JG.cop20k_like(scale=0.02)
    tc = TG.cop20k_like(scale=0.02)
    want = np.asarray(jc.astype(jnp.bfloat16).values).view(np.uint16)
    for dt in (torch.bfloat16, np.uint16):
        got = tc.astype(dt).values
        assert got.dtype == np.uint16
        np.testing.assert_array_equal(got, want)
    coo = tc.to_coo().astype(torch.bfloat16)
    np.testing.assert_array_equal(coo.values, want)
    np.testing.assert_array_equal(
        tc.astype(np.float32).values,
        np.asarray(jc.astype(np.float32).values))


def test_bf16_oracle_matches_jax():
    jc = JG.cop20k_like(scale=0.02).astype(jnp.bfloat16)
    tc = TG.cop20k_like(scale=0.02).astype(torch.bfloat16)
    jv, tv = _fat(tc.shape[1], 8, seed=8, dtype="bfloat16")
    want = jax_oracle(jc, np.asarray(jv))
    got = spmm_host_f64(tc, _tbits(tv))
    np.testing.assert_array_equal(got, want)
    assert default_tolerance(torch.bfloat16) == 1e-1
    assert default_tolerance(torch.float32) == 5e-3
    assert default_tolerance(torch.float64) == 1e-6


@pytest.mark.parametrize("kw", [{}, dict(pairs_per_step=2)],
                         ids=["auto", "U2"])
def test_run_benchmark_bf16_on_cpu(kw):
    csr = TG.cop20k_like(scale=0.02)
    rec = run_benchmark(csr, 32, Auto(**kw), "cpu", dtype=torch.bfloat16,
                        warmup=1, iters=1)
    jrec = jax_run_benchmark(JG.cop20k_like(scale=0.02), 32, JAuto(**kw),
                             make_mesh(1), dtype=jnp.bfloat16, warmup=1,
                             iters=1)
    assert rec.correct is True and jrec.correct is True
    assert rec.dtype == "bfloat16" and rec.nnz == jrec.nnz
    rec = run_benchmark(csr, 32, Auto(**kw), "cpu", dtype=torch.bfloat16,
                        warmup=1, iters=1, amortized=True, inner=2)
    assert rec.correct is True


# ---- the slice as a whole ----------------------------------------------

SLICE = {
    # name: (matrix, from_csr kwargs, k, dtype)
    "U2-f32-spill": (lambda g: g.powerlaw_csr(2000, 2000, 20000, seed=7),
                     dict(block_rows=128, chunk_cols=128, pairs_per_step=2,
                          beat_gather_margin=np.inf), 16, np.float32),
    "U2-bf16": (lambda g: g.fem3d_csr(512, 8192, seed=8),
                dict(block_rows=32, pairs_per_step=2, **PINNED), 16,
                "bfloat16"),
    "U2-f32-k12": (lambda g: g.fem3d_csr(512, 8192, seed=9),
                   dict(block_rows=32, pairs_per_step=2, **PINNED), 12,
                   np.float32),
    "phased": (lambda g: g.banded_csr(512, 24, 8, seed=4),
               dict(block_rows=128, pairs_per_step=16, phase_layout=True,
                    **PINNED), 8, np.float32),
}


@pytest.mark.parametrize("name", sorted(SLICE))
def test_spmm_windowed_generations_vs_jax_and_oracle(name):
    make, kw, k, dtype = SLICE[name]
    jc, tc = _csrs(make, dtype)
    jw = JW.WindowedPairs.from_csr(jc, **kw)
    tw = TW.WindowedPairs.from_csr(tc, **kw)
    _assert_phase_fields_equal(jw, tw)
    if name == "U2-f32-spill":
        assert tw.spill is not None
    tw = tw.to("cpu")
    jv, tv = _fat(tc.shape[1], k, seed=10, dtype=dtype)
    want = np.asarray(JOW.spmm_windowed(jw, jnp.asarray(jv),
                                        use_pallas=True), np.float64)
    got = TOW.spmm_windowed(tw, tv).double().numpy()
    ref = spmm_host_f64(tc, _tbits(tv))
    assert _rel(got, ref) < TIER[dtype]
    assert _rel(got, want) < TIER[dtype]


def test_phased_chain_vs_jax_chain_and_oracle():
    make = lambda g: g.banded_csr(1024, 24, 8, seed=41)  # noqa: E731
    jc, tc = _csrs(make, np.float32)
    jw = _multi_phase(JW.WindowedPairs.from_csr(
        jc, block_rows=128, pairs_per_step=8, phase_layout=True, **PINNED))
    tw = _port(jw).to("cpu")
    assert tw.supports_transposed_chain
    jv, tv = _fat(1024, 8, seed=42)
    jenc, jbody, jdec = JOW.windowed_t_chain(jw, 8, interpret=True)
    enc, body, dec = TOW.windowed_t_chain(tw, 8)
    js, ts = jenc(jnp.asarray(jv), jw), enc(tv, tw)
    ref = jv.astype(np.float64)
    for _ in range(3):
        js, ts = jbody(js, jw), body(ts, tw)
        ref = spmm_host_f64(tc, ref)
    got, want = dec(ts, tw).numpy(), np.asarray(jdec(js, jw))
    assert _rel(got, want) < 5e-3
    assert _rel(got, ref) < 2e-2  # three bf16 hi|lo round trips


@pytest.mark.parametrize("kw", [dict(pairs_per_step=2),
                                dict(phase_layout=True)],
                         ids=["U2", "phased"])
def test_auto_routes_the_generations_like_jax(kw):
    jc, tc = _csrs(lambda g: g.cop20k_like(scale=0.03), np.float32)
    jo = JA.auto_format(jc, **kw)
    to = TA.auto_format(tc, **kw)
    assert type(to).__name__ == type(jo).__name__ == "WindowedPairs"
    _assert_phase_fields_equal(jo, to)
    assert (to.block_rows, to.chunk_cols, to.pairs_per_step) == \
        (jo.block_rows, jo.chunk_cols, jo.pairs_per_step)
    if "phase_layout" in kw:
        assert to.phases is not None
    rec = run_benchmark(TG.cop20k_like(scale=0.03), 32, Auto(**kw), "cpu",
                        dtype=np.float32, warmup=1, iters=1, amortized=True,
                        inner=2)
    assert rec.correct is True


# ---- card copies and the two-pair audit ----------------------------------

def test_moving_an_odd_run_two_pair_operand_to_the_card_raises():
    csr = TG.fem3d_csr(512, 8192, seed=2).astype(np.float32)
    u4 = TW.WindowedPairs.from_csr(csr, block_rows=8, pairs_per_step=4,
                                   **PINNED)
    assert (np.diff(u4.block_ptr) % 2).any()  # odd runs
    odd = dataclasses.replace(u4, pairs_per_step=2, tiles_t=None)
    # The audit runs on the host arrays, before anything reaches a card.
    with pytest.raises(ValueError, match="two-pair kernel contract"):
        odd.to("cuda")
    assert odd.to("cpu").device.type == "cpu"


@pytest.mark.parametrize("name", ["U2-f32-spill", "phased"])
def test_plain_path_rebuilds_tiles_from_the_kept_planes(name):
    """What ``to`` leaves on a card (U=2 f32: ``tiles_split`` only, as
    its natural compact plane; a phase layout: the phase-major
    ``tiles_t`` only) still runs the plain path, for the narrow-k
    route."""
    make, kw, _, _ = SLICE[name]
    tc = make(TG).astype(np.float32)
    full = TW.WindowedPairs.from_csr(tc, **kw).to("cpu")
    drop = dict(tiles=None) if name.startswith("U2") else dict(
        tiles=None, tiles_split=None)
    bare = dataclasses.replace(full, **drop)
    assert bare.dtype == full.dtype == torch.float32
    v = torch.from_numpy(TG.generate_fat_vector(tc.shape[1], 5, seed=12)
                         .astype(np.float32))
    got = TOW.spmm_windowed(bare, v).numpy()
    if name.startswith("U2"):
        compact = dataclasses.replace(
            bare, tiles_split=TW.CompactTiles.from_natural(
                full.tiles_split, True).to("cpu"))
        assert compact.split and compact.dtype == torch.float32
        assert np.array_equal(TOW.spmm_windowed(compact, v).numpy(), got)
    want = TOW.spmm_windowed(full, v).numpy()
    cond = spmm_host_f64(dataclasses.replace(tc, values=np.abs(tc.values)),
                         np.abs(v.numpy()))
    # hi + lo is each f32 tile to 2**-17 relative.
    assert bool((np.abs(got - want) <= (2.0 ** -17 + 1e-6) * cond
                 + 1e-30).all())
