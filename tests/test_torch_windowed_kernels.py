"""The port's kernel modules on the CPU: the plain versions of B2
(``chunk_slabs``) and B1 (``windowed_matmul_tmulti``) against the JAX
package's Pallas kernels run in interpret mode on the same operand, the
windowed SpMM paths that use them, and the dispatch rules — a CPU tensor
takes the plain version, any other tensor the kernel or an error, and a
missing ``nvcc`` raises instead of falling back.

Tolerances: B2 is a relayout plus round-to-nearest-even splits, so it
must be bitwise equal. B1 sums exact bf16 x bf16 products in f32 in
another order than the interpreter, so ``|diff| <= 1e-5 * cond + 1e-6``
with ``cond`` the same contraction over the planes' absolute values.
Whole SpMMs are held to the f32 tier (5e-3 relative to the largest
output) against each other and the host f64 oracle.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sparsematrixmultiplicationmpi_tpu.formats.windowed as JW
import sparsematrixmultiplicationmpi_tpu.io.generate as JG
import sparsematrixmultiplicationmpi_tpu.ops.pallas_windowed as JP
import sparsematrixmultiplicationmpi_tpu.ops.windowed as JOW
import sparsematrixmultiplicationmpi_tpu_torch.formats.windowed as TW
import sparsematrixmultiplicationmpi_tpu_torch.io.generate as TG
from sparsematrixmultiplicationmpi_tpu_torch.ops import _kernel_lib
from sparsematrixmultiplicationmpi_tpu_torch.ops import cuda_windowed as cw
from sparsematrixmultiplicationmpi_tpu_torch.ops import windowed as TOW
from sparsematrixmultiplicationmpi_tpu_torch.ops.oracle import spmm_host_f64

RTOL, ATOL = 1e-5, 1e-6


def _operands(make, **kw):
    """The JAX package's operand and the identical port operand on the
    CPU (through ``from_arrays``)."""
    jw = JW.WindowedPairs.from_csr(make(JG).astype(np.float32), **kw)
    fields = {f.name: getattr(jw, f.name) for f in dataclasses.fields(jw)}
    return jw, TW.WindowedPairs.from_arrays(**fields).to("cpu")


def _fem(m, nnz, seed):
    return lambda g: g.fem3d_csr(m, nnz, seed=seed)


PINNED = dict(chunk_cols=128, reorder=None, beat_gather_margin=1e9,
              max_inflation=1e9)


def _fat(n, k, seed):
    return JG.generate_fat_vector(n, k, seed=seed).astype(np.float32)


@pytest.mark.parametrize("k", [8, 16, 24])
@pytest.mark.parametrize("split", [True, False])
def test_plain_chunk_slabs_bitwise_vs_jax(k, split):
    rng = np.random.default_rng(k)
    v = rng.normal(scale=30.0, size=(384, k)).astype(np.float32)
    (want,) = JP.chunk_slabs(jnp.asarray(v), C=128, split=split,
                             interpret=True)
    got = cw.chunk_slabs(torch.from_numpy(v), C=128, split=split)
    want = np.asarray(want)
    if split:
        want = want.view(np.uint16)
        got = got.view(torch.int16).numpy().view(np.uint16)
    else:
        got = got.numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _b1_case(jw, tw, k, seed, fuse):
    v = _fat(tw.shape[1], k, seed)
    (jslabs,) = JP.chunk_slabs(jw.encode(jnp.asarray(v)), C=128, split=True,
                               interpret=True)
    slabs = cw.chunk_slabs(tw.encode(torch.from_numpy(v)).contiguous(),
                           C=128, split=True)
    np.testing.assert_array_equal(
        slabs.view(torch.int16).numpy().view(np.uint16),
        np.asarray(jslabs).view(np.uint16))
    want = JP.windowed_matmul_tmulti(
        jw.pair_block, jw.pair_chunk, jnp.asarray(jw.tiles_t), jslabs,
        nb=jw.n_blocks, pairs_per_step=jw.pairs_per_step, split=True,
        interpret=True, fuse_resplit=fuse)
    got = cw.windowed_matmul_tmulti(
        tw.pair_block, tw.pair_chunk, tw.block_ptr, tw.tiles_t, slabs,
        nb=tw.n_blocks, pairs_per_step=tw.pairs_per_step, fuse_resplit=fuse)
    cond = cw.windowed_matmul_tmulti_plain(
        tw.pair_block, tw.pair_chunk, tw.tiles_t.abs(), slabs.abs(),
        nb=tw.n_blocks).numpy()
    want = np.asarray(want)
    if fuse:
        w = want.shape[-1] // 2
        want = want[..., :w].astype(np.float32) + \
            want[..., w:].astype(np.float32)
        got = got[..., :w].float() + got[..., w:].float()
        # Each side's hi + lo is its own f32 sum to 2**-17 relative; two
        # sums a hair apart may round to states 2**-16 relative apart.
        cond = cond + np.abs(want) * (2.0 ** -16 / RTOL)
    got = got.numpy()
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= RTOL * cond + ATOL)


@pytest.mark.parametrize("U", [4, 8, 16])
@pytest.mark.parametrize("fuse", [False, True])
def test_plain_tmulti_vs_jax_interpret(U, fuse):
    jw, tw = _operands(_fem(256, 4096, 0), block_rows=16,
                       pairs_per_step=U, **PINNED)
    _b1_case(jw, tw, 16, seed=1, fuse=fuse)


def test_plain_tmulti_spans_blocks_vs_jax_interpret():
    jw, tw = _operands(_fem(512, 8192, 2), block_rows=8, pairs_per_step=8,
                       **PINNED)
    assert (np.diff(tw.block_ptr.numpy()) % 8 != 0).any()
    _b1_case(jw, tw, 16, seed=3, fuse=False)


def test_plain_fused_state_is_split_of_unfused():
    _, tw = _operands(lambda g: g.banded_csr(512, 24, 8, seed=4),
                      block_rows=128, pairs_per_step=8, **PINNED)
    v = torch.from_numpy(_fat(512, 16, 5))
    slabs = cw.chunk_slabs(tw.encode(v).contiguous(), C=128, split=True)
    args = (tw.pair_block, tw.pair_chunk, tw.block_ptr, tw.tiles_t, slabs)
    out = cw.windowed_matmul_tmulti(*args, nb=tw.n_blocks, pairs_per_step=8)
    fused = cw.windowed_matmul_tmulti(*args, nb=tw.n_blocks,
                                      pairs_per_step=8, fuse_resplit=True)
    assert torch.equal(fused.view(torch.int16),
                       cw.resplit_slabs(out).view(torch.int16))
    jres = JP.resplit_slabs(jnp.asarray(out.numpy()))
    np.testing.assert_array_equal(
        np.asarray(jres).view(np.uint16),
        fused.view(torch.int16).numpy().view(np.uint16))


def test_tmulti_contract_checks():
    _, tw = _operands(_fem(256, 4096, 0), block_rows=16, pairs_per_step=8,
                      **PINNED)
    v = torch.from_numpy(_fat(256, 8, 6))
    slabs = cw.chunk_slabs(tw.encode(v).contiguous(), C=128, split=True)
    args = (tw.pair_block, tw.pair_chunk, tw.block_ptr, tw.tiles_t, slabs)
    with pytest.raises(ValueError, match="fuse_resplit"):
        cw.windowed_matmul_tmulti(*args, nb=tw.n_blocks, pairs_per_step=8,
                                  fuse_resplit=True)
    with pytest.raises(ValueError, match="multiple of pairs_per_step"):
        cw.windowed_matmul_tmulti(*args, nb=tw.n_blocks, pairs_per_step=7)
    with pytest.raises(ValueError, match="slab width"):
        cw.windowed_matmul_tmulti(*args[:4], slabs[..., :128].contiguous(),
                                  nb=tw.n_blocks, pairs_per_step=8)
    with pytest.raises(ValueError, match="split=False requires bf16"):
        cw.windowed_matmul_tmulti(*args[:3], tw.tiles_t.float(), slabs,
                                  nb=tw.n_blocks, pairs_per_step=8,
                                  split=False)


@pytest.mark.parametrize("name", ["tmulti-U8", "spill", "u2"])
def test_spmm_windowed_cpu_matches_jax_and_oracle(name):
    make, kw, k = {
        "tmulti-U8": (_fem(256, 4096, 0),
                      dict(block_rows=16, pairs_per_step=8, **PINNED), 8),
        "spill": (lambda g: g.powerlaw_csr(2000, 2000, 20000, seed=7),
                  dict(block_rows=128, chunk_cols=128, pairs_per_step=8,
                       beat_gather_margin=np.inf), 12),
        "u2": (_fem(1024, 16000, 8),
               dict(pairs_per_step=2, beat_gather_margin=1e9), 5),
    }[name]
    csr = make(JG).astype(np.float32)
    jw, tw = _operands(make, **kw)
    v = _fat(csr.shape[1], k, 9)
    got = TOW.spmm_windowed(tw, torch.from_numpy(v)).numpy()
    want = np.asarray(JOW.spmm_windowed(jw, jnp.asarray(v),
                                        use_pallas=False))
    ref = spmm_host_f64(csr, v)
    scale = np.abs(ref).max()
    assert np.abs(got - want).max() / scale < 5e-3
    assert np.abs(got - ref).max() / scale < 5e-3
    iterated = tw.decode(tw.iterate(tw.encode(torch.from_numpy(v))))
    np.testing.assert_array_equal(iterated.numpy(), got)


def test_t_chain_cpu_matches_jax_chain():
    make = lambda g: g.banded_csr(512, 24, 8, seed=4)  # noqa: E731
    csr = make(JG).astype(np.float32)
    jw, tw = _operands(make, block_rows=128, pairs_per_step=8, **PINNED)
    v = _fat(512, 16, 10)
    jenc, jbody, jdec = JOW.windowed_t_chain(jw, 16, interpret=True)
    enc, body, dec = TOW.windowed_t_chain(tw, 16)
    js, ts = jenc(jnp.asarray(v), jw), enc(torch.from_numpy(v), tw)
    for _ in range(3):
        js, ts = jbody(js, jw), body(ts, tw)
    want, got = np.asarray(jdec(js, jw)), dec(ts, tw).numpy()
    assert np.abs(got - want).max() / np.abs(want).max() < 5e-3
    one = dec(body(enc(torch.from_numpy(v), tw), tw), tw).numpy()
    ref = spmm_host_f64(csr, v)
    assert np.abs(one - ref).max() / np.abs(ref).max() < 5e-3


def test_t_chain_gates_follow_the_reference():
    _, tw = _operands(lambda g: g.banded_csr(512, 24, 8, seed=4),
                      block_rows=128, pairs_per_step=8, **PINNED)
    assert TOW.windowed_t_chain(tw, 5) is None       # narrow unaligned k
    assert TOW.windowed_t_chain(tw, 12) is not None  # padded to 16
    _, spill = _operands(lambda g: g.powerlaw_csr(2000, 2000, 20000, seed=7),
                         block_rows=128, chunk_cols=128, pairs_per_step=8,
                         beat_gather_margin=np.inf)
    assert TOW.windowed_t_chain(spill, 8) is None
    _, r16 = _operands(_fem(256, 4096, 0), block_rows=16, pairs_per_step=8,
                       **PINNED)
    assert r16.to("meta").device.type == "meta"
    assert TOW.windowed_t_chain(r16.to("meta"), 8) is None  # R % 128


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_plain_path_rebuilds_tiles_from_transposed_planes(dtype):
    csr = TG.banded_csr(512, 24, 8, seed=4).astype(dtype)
    full = TW.WindowedPairs.from_csr(csr, block_rows=128, pairs_per_step=8,
                                     **PINNED).to("cpu")
    assert full.tiles is not None  # a host copy keeps every plane
    # What ``to`` leaves on a card for this operand: the kernels' planes.
    bare = dataclasses.replace(full, tiles=None, tiles_split=None)
    assert bare.split == full.split == (dtype == np.float32)
    assert bare.n_pairs == full.n_pairs
    v = torch.from_numpy(TG.generate_fat_vector(512, 5, seed=12)
                         .astype(dtype))
    got = TOW.spmm_windowed(bare, v).numpy()
    want = TOW.spmm_windowed(full, v).numpy()
    cond = spmm_host_f64(dataclasses.replace(csr, values=np.abs(csr.values)),
                         np.abs(v.numpy()))
    # hi + lo is each f32 tile to 2**-17 relative; one f64 plane is exact
    # and only the summation order may differ.
    rtol = 2.0 ** -17 + 1e-6 if dtype == np.float32 else 1e-12
    assert bool((np.abs(got - want) <= rtol * cond + 1e-30).all())
    ref = spmm_host_f64(csr, v.numpy())
    assert np.abs(got - ref).max() / np.abs(ref).max() < 5e-3
    # The transposed chain reads only tiles_t: the same state bit for bit.
    v16 = torch.from_numpy(TG.generate_fat_vector(512, 16, seed=13)
                           .astype(dtype))
    states = []
    for op in (full, bare):
        enc, body, dec = TOW.windowed_t_chain(op, 16)
        states.append(dec(body(enc(v16, op), op), op))
    assert torch.equal(*states)


def test_cpu_tensors_take_plain_and_count_nothing():
    _, tw = _operands(lambda g: g.banded_csr(512, 24, 8, seed=4),
                      block_rows=128, pairs_per_step=8, **PINNED)
    cw.reset_launch_counts()
    enc, body, dec = TOW.windowed_t_chain(tw, 16)
    dec(body(enc(torch.from_numpy(_fat(512, 16, 11)), tw), tw), tw)
    assert cw.launch_counts() == dict.fromkeys(
        ("B1", "B2", "B3", "B4", "B6"), 0)


def test_non_cpu_tensors_never_take_plain():
    v = torch.empty((256, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        cw.chunk_slabs(v, C=128, split=True)
    _, tw = _operands(_fem(256, 4096, 0), block_rows=16, pairs_per_step=8,
                      **PINNED)
    m = tw.to("meta")
    slabs = torch.empty((2, 8, 256), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        cw.windowed_matmul_tmulti(m.pair_block, m.pair_chunk, m.block_ptr,
                                  m.tiles_t, slabs, nb=m.n_blocks,
                                  pairs_per_step=8)


def test_loader_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    real_access = _kernel_lib.os.access
    monkeypatch.setattr(_kernel_lib.os, "access",
                        lambda p, mode: False if p.endswith("nvcc")
                        else real_access(p, mode))
    monkeypatch.setattr(_kernel_lib, "_lib", None)
    assert _kernel_lib.find_nvcc() is None
    with pytest.raises(_kernel_lib.KernelBuildError, match="nvcc not found"):
        _kernel_lib.load_library()


def test_loader_raises_with_compiler_output(monkeypatch, tmp_path):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no sm_90a here' >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_kernel_lib, "_lib", None)
    monkeypatch.setattr(_kernel_lib, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(_kernel_lib.KernelBuildError, match="no sm_90a here"):
        _kernel_lib.load_library()
