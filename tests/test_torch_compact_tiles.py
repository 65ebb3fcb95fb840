"""The compact tile plane (``formats/windowed.py::CompactTiles``) that
kernels B1 and B6 read on the card, and its natural orientation that B3
and B4 bf16 read, on the CPU: its round trip, the plain B1 / B6 on it
against the JAX package's kernels in interpret mode, the host operand it
leaves untouched, and the wrappers' refusal of a dense plane off the
CPU.

Tolerances: the round trip is bitwise (an entry is any position where a
plane's bits are non-zero). The plain versions densify the plane and
mirror the JAX package, so they are bitwise equal to the same call on the
dense plane, and within ``1e-5 * cond + 1e-6`` of the interpreter (exact
bf16 x bf16 products summed in f32 in another order; ``cond`` the same
contraction over absolute values).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sparsematrixmultiplicationmpi_tpu.formats.windowed as JW
import sparsematrixmultiplicationmpi_tpu.io.generate as JG
import sparsematrixmultiplicationmpi_tpu.ops.pallas_windowed as JP
import sparsematrixmultiplicationmpi_tpu_torch.formats.windowed as TW
from sparsematrixmultiplicationmpi_tpu_torch.formats.windowed import (
    CompactTiles,
)
from sparsematrixmultiplicationmpi_tpu_torch.ops import cuda_windowed as cw
from sparsematrixmultiplicationmpi_tpu_torch.ops import windowed as TOW

RTOL, ATOL = 1e-5, 1e-6
PINNED = dict(chunk_cols=128, reorder=None, beat_gather_margin=1e9,
              max_inflation=1e9)


def _bits(x):
    """Host array as comparable bits: bf16 (ml_dtypes or uint16) as
    uint16, anything else as it is."""
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.itemsize == 2 else x


def _port(jw):
    fields = {f.name: getattr(jw, f.name) for f in dataclasses.fields(jw)}
    return TW.WindowedPairs.from_arrays(**fields)


def _multi_phase(jw, cpp=2):
    """A JAX operand rebuilt with ``cpp`` chunks per phase, as
    ``tests/test_phased.py`` does (several phases, dummy tiles)."""
    tiles_t, pb_ph, pc_ph, phases = JW._phase_fields(
        np.asarray(jw.tiles),
        None if jw.tiles_split is None else np.asarray(jw.tiles_split),
        jw.pair_block, jw.pair_chunk, jw.n_blocks, jw.n_chunks, cpp,
        jw.pairs_per_step)
    return dataclasses.replace(jw, tiles_t=tiles_t, pair_block_ph=pb_ph,
                               pair_chunk_ph=pc_ph, phases=phases,
                               chunks_per_phase=cpp)


#: The operand families of tests/test_tmulti.py and tests/test_phased.py,
#: built by the JAX package.
JAX_FAMILIES = {
    "tmulti-U4": (lambda g: g.fem3d_csr(256, 4096, seed=0), np.float32,
                  dict(block_rows=16, pairs_per_step=4)),
    "tmulti-U8": (lambda g: g.fem3d_csr(256, 4096, seed=0), np.float32,
                  dict(block_rows=16, pairs_per_step=8)),
    "tmulti-U16": (lambda g: g.fem3d_csr(256, 4096, seed=0), np.float32,
                   dict(block_rows=16, pairs_per_step=16)),
    "spans-blocks-R8": (lambda g: g.fem3d_csr(512, 8192, seed=2),
                        np.float32, dict(block_rows=8, pairs_per_step=8)),
    "banded-R128": (lambda g: g.banded_csr(512, 24, 8, seed=4), np.float32,
                    dict(block_rows=128, pairs_per_step=8)),
    "banded-bf16": (lambda g: g.banded_csr(512, 24, 8, seed=4), "bfloat16",
                    dict(block_rows=128, pairs_per_step=8)),
    "fem-f64": (lambda g: g.fem3d_csr(256, 4096, seed=0), np.float64,
                dict(block_rows=16, pairs_per_step=8)),
    "phased-single": (lambda g: g.banded_csr(512, 24, 8, seed=4),
                      np.float32, dict(block_rows=128, pairs_per_step=8,
                                       phase_layout=True)),
    "phased-multi": (lambda g: g.fem3d_csr(1024, 16384, seed=11),
                     np.float32, dict(block_rows=128, pairs_per_step=8,
                                      phase_layout=True)),
}


def _jax_operand(name):
    make, dtype, kw = JAX_FAMILIES[name]
    csr = make(JG).astype(jnp.bfloat16 if dtype == "bfloat16" else dtype)
    jw = JW.WindowedPairs.from_csr(csr, **kw, **PINNED)
    if name == "phased-multi":
        jw = _multi_phase(jw)
    return jw


def _synthetic(name):
    """Planes built to hit the plane's edges: a fully dense 256 x 256 tile
    (C * R entries need int32 column offsets), C = 512 (int16 rows), R = 8,
    an all-zero tile, a full column, -0.0 and lo-only entries."""
    C, R, split = {"dense-256": (256, 256, True), "C512": (512, 128, True),
                   "R8": (128, 8, True), "one-plane": (128, 128, False)}[name]
    rng = np.random.default_rng(C + R)
    P = 4
    t = rng.integers(1, 2 ** 16, size=(P, (2 if split else 1) * C, R),
                     dtype=np.uint16)
    keep = rng.random((P, C, R)) < 0.03
    keep[0] = True
    keep[1] = False
    keep[2, :, R - 1] = True
    t *= np.concatenate([keep] * (2 if split else 1), axis=1)
    t[3, 0, 0] = 0x8000  # -0.0: a non-zero bit pattern
    if split:
        t[3, 1, 1] = 0
        t[3, C + 1, 1] = 0x1234  # an entry whose hi plane is zero
    return t, split


def _planes(name):
    if name in JAX_FAMILIES:
        jw = _jax_operand(name)
        return _bits(jw.tiles_t), jw.tiles_split is not None
    return _synthetic(name)


@pytest.mark.parametrize("name", [*JAX_FAMILIES, "dense-256", "C512", "R8",
                                  "one-plane"])
def test_round_trip_is_bitwise(name):
    tiles_t, split = _planes(name)
    ct = CompactTiles.from_dense(tiles_t, split)
    P, CW, R = tiles_t.shape
    C = CW // 2 if split else CW
    assert ct.shape == tiles_t.shape and ct.split == split
    got = ct.to_dense()
    assert got.dtype == tiles_t.dtype
    np.testing.assert_array_equal(got, tiles_t)
    # On torch tensors (what a card copy holds) the same bits come back.
    dense = ct.to("cpu").to_dense()
    if tiles_t.dtype == np.uint16:
        dense = dense.view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(np.asarray(dense), tiles_t)
    # One entry per non-zero (c, r) of any plane, in (pair, r, c) order.
    bits = tiles_t.view(np.dtype(f"u{tiles_t.dtype.itemsize}"))
    nz = (bits[:, :C] != 0) | (bits[:, C:] != 0) if split else bits != 0
    assert ct.nnz == int(nz.sum())
    assert ct.col_ptr.dtype == (np.uint16 if C * R <= 65535 else np.int32)
    assert ct.rows.dtype == (np.uint8 if C <= 256 else np.int16)
    cp = ct.col_ptr.astype(np.int64)
    assert (np.diff(cp, axis=1) >= 0).all() and (cp[:, 0] == 0).all()
    np.testing.assert_array_equal(np.diff(ct.pair_nz_ptr), cp[:, -1])
    key = (np.repeat(np.arange(P * R), np.diff(cp, axis=1).ravel()) * C
           + ct.rows.astype(np.int64))
    assert (np.diff(key) > 0).all()


@pytest.mark.parametrize("name", ["phased-multi", "dense-256"])
def test_a_run_of_pairs_is_an_offset(name):
    tiles_t, split = _planes(name)
    ct = CompactTiles.from_dense(tiles_t, split)
    for a, b in ((0, 1), (1, 3), (2, tiles_t.shape[0])):
        part = ct[a:b]
        assert part.rows is ct.rows and part.vals is ct.vals
        assert part.nnz == int(ct.pair_nz_ptr[b] - ct.pair_nz_ptr[a])
        np.testing.assert_array_equal(part.to_dense(), tiles_t[a:b])
    with pytest.raises(ValueError, match="unit-step"):
        ct[::2]


def _b1_jax_and_port(jw, tw, k, seed, fuse):
    v = JG.generate_fat_vector(tw.shape[1], k, seed=seed).astype(np.float32)
    (jslabs,) = JP.chunk_slabs(jw.encode(jnp.asarray(v)), C=128, split=True,
                               interpret=True)
    slabs = cw.chunk_slabs(tw.encode(torch.from_numpy(v)).contiguous(),
                           C=128, split=True)
    want = np.asarray(JP.windowed_matmul_tmulti(
        jw.pair_block, jw.pair_chunk, jnp.asarray(jw.tiles_t), jslabs,
        nb=jw.n_blocks, pairs_per_step=jw.pairs_per_step, split=True,
        interpret=True, fuse_resplit=fuse))
    return slabs, want


@pytest.mark.parametrize("U", [4, 8, 16])
@pytest.mark.parametrize("fuse", [False, True])
def test_plain_b1_on_the_compact_plane_vs_jax_interpret(U, fuse):
    jw = _jax_operand(f"tmulti-U{U}")
    tw = _port(jw).to("cpu")
    slabs, want = _b1_jax_and_port(jw, tw, 16, seed=1, fuse=fuse)
    ct = CompactTiles.from_dense(tw.tiles_t, True).to("cpu")
    args = (tw.pair_block, tw.pair_chunk, tw.block_ptr)
    kw = dict(nb=tw.n_blocks, pairs_per_step=U, fuse_resplit=fuse)
    got = cw.windowed_matmul_tmulti(*args, ct, slabs, **kw)
    dense = cw.windowed_matmul_tmulti(*args, tw.tiles_t, slabs, **kw)
    assert torch.equal(got, dense)
    cond = cw.windowed_matmul_tmulti_plain(
        tw.pair_block, tw.pair_chunk, tw.tiles_t.abs(), slabs.abs(),
        nb=tw.n_blocks).numpy()
    if fuse:
        w = want.shape[-1] // 2
        want = want[..., :w].astype(np.float32) + \
            want[..., w:].astype(np.float32)
        got = got[..., :w].float() + got[..., w:].float()
        # Each side's hi + lo is its own f32 sum to 2**-17 relative.
        cond = cond + np.abs(want) * (2.0 ** -16 / RTOL)
    got = got.numpy()
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= RTOL * cond + ATOL)


@pytest.mark.parametrize("kind,streamed", [
    ("phased-single", False), ("phased-multi", False),
    ("phased-multi", True)])
def test_plain_b6_on_the_compact_plane_vs_jax_interpret(kind, streamed):
    jw = _jax_operand(kind)
    tw = _port(jw).to("cpu")
    v = JG.generate_fat_vector(tw.shape[1], 16, seed=4).astype(np.float32)
    (jslabs,) = JP.chunk_slabs(jw.encode(jnp.asarray(v)), C=128,
                               split=True, interpret=True)
    want = np.asarray(JP.windowed_matmul_tmulti_phased(
        jw.pair_block_ph, jw.pair_chunk_ph, jnp.asarray(jw.tiles_t), jslabs,
        nb=jw.n_blocks, phases=jw.phases,
        chunks_per_phase=jw.chunks_per_phase, pairs_per_step=8,
        split=True, interpret=True, force_streamed=streamed))
    slabs = cw.chunk_slabs(tw.encode(torch.from_numpy(v)).contiguous(),
                           C=128, split=True)
    ct = CompactTiles.from_dense(tw.tiles_t, True).to("cpu")
    args = (tw.pair_block_ph, tw.pair_chunk_ph, tw.block_ptr_ph)
    kw = dict(nb=tw.n_blocks, phases=tw.phases, split=True,
              chunks_per_phase=tw.chunks_per_phase, pairs_per_step=8,
              force_streamed=streamed)
    got = cw.windowed_matmul_tmulti_phased(*args, ct, slabs, **kw)
    assert torch.equal(got, cw.windowed_matmul_tmulti_phased(
        *args, tw.tiles_t, slabs, **kw))
    cond = cw.windowed_matmul_tmulti_phased_plain(
        tw.pair_block_ph, tw.pair_chunk_ph, tw.tiles_t.abs(), slabs.abs(),
        nb=tw.n_blocks, phases=tw.phases).numpy()
    assert np.all(np.abs(got.numpy() - want) <= RTOL * cond + ATOL)


@pytest.mark.parametrize("name", ["banded-R128", "banded-bf16",
                                  "phased-multi", "tmulti-U8"])
def test_to_leaves_the_host_operand_bit_identical(name):
    jw = _jax_operand(name)
    tw = _port(jw)
    copies = [tw.to("cpu"), tw.to("meta")]
    for f in TW.WindowedPairs._ARRAYS:
        b = getattr(tw, f)
        # block_ptr_ph is the port's own work list, derived on the host.
        a = getattr(jw, f) if hasattr(jw, f) else b
        assert (a is None) == (b is None), f
        if a is None:
            continue
        a = _bits(a)
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
        got = getattr(copies[0], f)
        if got.dtype == torch.bfloat16:
            got = got.view(torch.int16).numpy().view(np.uint16)
        np.testing.assert_array_equal(np.asarray(got), a, err_msg=f)
    assert (tw.block_rows, tw.chunk_cols, tw.pairs_per_step, tw.n_pairs,
            tw.phases) == (jw.block_rows, jw.chunk_cols, jw.pairs_per_step,
                           jw.n_pairs, jw.phases)
    # Off the card, every copy keeps the dense plane.
    assert all(isinstance(c.tiles_t, torch.Tensor) for c in copies)


def test_dense_tiles_off_the_cpu_never_reach_a_kernel():
    tw = _port(_jax_operand("phased-multi"))
    m = tw.to("meta")
    slabs = torch.empty((m.n_chunks, 8, 256), dtype=torch.bfloat16,
                        device="meta")
    ct = CompactTiles.from_dense(tw.tiles_t, True).to("meta")
    phased_kw = dict(nb=m.n_blocks, phases=m.phases,
                     chunks_per_phase=m.chunks_per_phase, pairs_per_step=8)
    for tiles, match in ((m.tiles_t, "no kernel for a dense tiles_t on "
                          "meta"), (ct, "no kernel for a tensor on meta")):
        with pytest.raises(ValueError, match=match):
            cw.windowed_matmul_tmulti(m.pair_block_ph, m.pair_chunk_ph,
                                      m.block_ptr_ph[:m.phases[0][4] + 1],
                                      tiles, slabs, nb=m.phases[0][4],
                                      pairs_per_step=8)
        with pytest.raises(ValueError, match=match):
            cw.windowed_matmul_tmulti_phased(
                m.pair_block_ph, m.pair_chunk_ph, m.block_ptr_ph, tiles,
                slabs, **phased_kw)


@pytest.mark.parametrize("name", ["banded-R128", "phased-multi"])
def test_plain_path_on_a_copy_holding_the_compact_plane(name):
    """A copy whose ``tiles_t`` is the compact plane (what ``to`` leaves
    on a card) runs the plain one-shot and chain paths to the same bits
    as one holding the dense plane."""
    tw = _port(_jax_operand(name)).to("cpu")
    dense = dataclasses.replace(tw, tiles=None, tiles_split=None)
    compact = dataclasses.replace(
        dense, tiles_t=CompactTiles.from_dense(tw.tiles_t, True).to("cpu"))
    assert compact.split and compact.dtype == torch.float32
    assert compact.supports_transposed_chain
    v = torch.from_numpy(JG.generate_fat_vector(tw.shape[1], 16, seed=12)
                         .astype(np.float32))
    for k in (5, 16):
        assert torch.equal(TOW.spmm_windowed(compact, v[:, :k]),
                           TOW.spmm_windowed(dense, v[:, :k]))
    states = []
    for op in (dense, compact):
        enc, body, dec = TOW.windowed_t_chain(op, 16)
        states.append(dec(body(body(enc(v, op), op), op), op))
    assert torch.equal(*states)


#: U=2 builds of the JAX package (the two-pair route's families): R = 8,
#: R = 16, R = 128, and C = 512 at R = 256 (int16 rows, int32 column
#: offsets).
U2_FAMILIES = {
    "fem-R16": (lambda g: g.fem3d_csr(256, 4096, seed=0),
                dict(block_rows=16, chunk_cols=128)),
    "fem-R8": (lambda g: g.fem3d_csr(512, 8192, seed=2),
               dict(block_rows=8, chunk_cols=128, allow_spill=False)),
    "banded-R128": (lambda g: g.banded_csr(512, 24, 8, seed=4),
                    dict(block_rows=128, chunk_cols=128)),
    "fem-C512": (lambda g: g.fem3d_csr(1024, 16000, seed=8),
                 dict(block_rows=256, chunk_cols=512)),
}


def _u2_port(name, dtype):
    make, kw = U2_FAMILIES[name]
    csr = make(JG).astype(jnp.bfloat16 if dtype == "bfloat16" else dtype)
    pinned = {**PINNED, **kw}
    jw = JW.WindowedPairs.from_csr(csr, pairs_per_step=2, **pinned)
    return _port(jw)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("name", sorted(U2_FAMILIES))
def test_natural_plane_round_trip_is_bitwise(name, dtype):
    """The natural plane of a U=2 operand's ``tiles_split`` (f32) or
    ``tiles`` (bf16): the arrays of ``from_dense`` of the transposed
    planes, the natural shape, and the planes back bit for bit, on the
    host and as CPU tensors."""
    tw = _u2_port(name, dtype)
    split = dtype == np.float32
    plane = tw.natural_plane
    assert plane is (tw.tiles_split if split else tw.tiles)
    assert plane is not None and plane.dtype == np.uint16
    ct = CompactTiles.from_natural(plane, split)
    ref = CompactTiles.from_dense(np.ascontiguousarray(
        plane.swapaxes(1, 2)), split)
    for f in ("pair_nz_ptr", "col_ptr", "rows", "vals"):
        a, b = getattr(ct, f), getattr(ref, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    P, R, CW = plane.shape
    C = tw.chunk_cols
    assert ct.natural and not ref.natural and ct.split == split
    assert ct.shape == plane.shape and ref.shape == (P, CW, R)
    assert ct.wide == (int(C * R > 65535) | int(C > 256) << 1)
    if name == "fem-C512":
        assert ct.wide == 3
    if name == "fem-R8":
        assert R == 8
    np.testing.assert_array_equal(ct.to_dense(), plane)
    np.testing.assert_array_equal(
        ct.to("cpu").to_dense().view(torch.int16).numpy().view(np.uint16),
        plane)
    half = P // 2
    np.testing.assert_array_equal(ct[half:].to_dense(), plane[half:])
    # From a CPU tensor, the same arrays.
    t = ct.to("cpu")
    again = CompactTiles.from_natural(t.to_dense(), split)
    for f in ("pair_nz_ptr", "col_ptr", "rows", "vals"):
        np.testing.assert_array_equal(getattr(again, f), getattr(ct, f))


def test_off_the_card_copies_keep_the_dense_natural_planes():
    """Off the card nothing is compacted, and the gate of ``to`` is
    ``COMPACT_MAX_C``: the widest chunk the compact kernels stage."""
    assert TW.COMPACT_MAX_C == 512
    tw = _u2_port("fem-R16", np.float32)
    for dev in ("cpu", "meta"):
        copy = tw.to(dev)
        assert isinstance(copy.tiles_split, torch.Tensor)
        assert isinstance(copy.tiles, torch.Tensor)
