"""The port's band-kernel module on the CPU: the plain version of B5
(``band_matmul_plain``) against the JAX package's Pallas band kernel run in
interpret mode, ``spmm_banded_cuda``'s CPU path against
``spmm_banded_pallas`` on the ``tests/test_pallas.py`` families, the
completed ``BandedBlocks``, ``spmm_any``'s band routes, and the kernel
library's build of every ``csrc/*.cu``.

Tolerances: both sides sum the same f32 products in another order, so
``|diff| <= 1e-5 * cond + 1e-6`` with ``cond`` the same contraction over
absolute values. A bf16 band's result is rounded to bf16 once on each
side, so two sums that close may round one bf16 ulp apart: the bound adds
``2**-7 * |result|``.
"""

import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sparsematrixmultiplicationmpi_tpu.formats.banded as JB
import sparsematrixmultiplicationmpi_tpu.io.generate as JG
from sparsematrixmultiplicationmpi_tpu.formats.matrix import CSR as JCSR
from sparsematrixmultiplicationmpi_tpu.ops.pallas_banded import (
    band_matmul_pallas, spmm_banded_pallas,
)
import sparsematrixmultiplicationmpi_tpu_torch.formats.banded as TB
import sparsematrixmultiplicationmpi_tpu_torch.io.generate as TG
import sparsematrixmultiplicationmpi_tpu_torch.ops.auto as TA
from sparsematrixmultiplicationmpi_tpu_torch.formats.matrix import CSR
from sparsematrixmultiplicationmpi_tpu_torch.ops import _kernel_lib
from sparsematrixmultiplicationmpi_tpu_torch.ops import cuda_banded as cb
from sparsematrixmultiplicationmpi_tpu_torch.ops.oracle import spmm_host_f64

RTOL, ATOL = 1e-5, 1e-6
BF16_ULP = 2.0 ** -7


def _band(nb, r, seed, density=0.1):
    rng = np.random.default_rng(seed)
    band = rng.uniform(-1, 1, (nb, r, 3 * r)).astype(np.float32)
    band[rng.uniform(size=band.shape) > density] = 0.0
    return band


def _assert_close(got, want, cond, bf16=False):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    bound = RTOL * cond + ATOL + (BF16_ULP * np.abs(want) if bf16 else 0)
    assert (np.abs(got - want) <= bound).all(), np.abs(got - want).max()


def _jax_band_matmul(band_j, v, nb, r):
    """The JAX kernel on its own contract: v transposed, with one zero
    block in front and k padded to a multiple of 8."""
    n, k = v.shape
    k8 = -(-k // 8) * 8
    v_pad = jnp.zeros(((nb + 2) * r, k8), band_j.dtype)
    v_pad = v_pad.at[r: r + n, :k].set(jnp.asarray(v).astype(band_j.dtype))
    return band_matmul_pallas(band_j, v_pad.T, interpret=True)[:, :k]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [1, 6, 8, 32])
@pytest.mark.parametrize("r", [8, 128])
def test_plain_band_matmul_matches_jax_interpret(r, k, dtype):
    nb = 3
    band32 = _band(nb, r, seed=r + k)
    n = nb * r - 5  # a ragged end: the halo past n is zero
    v32 = np.random.default_rng(k).uniform(-1, 1, (n, k)).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    band_t = torch.from_numpy(band32).to(tdt)
    v_t = torch.from_numpy(v32).to(tdt)
    got = cb.band_matmul_plain(band_t, v_t)
    assert got.dtype == tdt and got.shape == (nb * r, k)
    want = _jax_band_matmul(jnp.asarray(band32).astype(jdt), v32, nb, r)
    cond = cb.band_matmul_plain(band_t.float().abs(), v_t.float().abs())
    _assert_close(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                  cond.double().numpy(), bf16=dtype == "bfloat16")
    # The wrapper takes the plain version for a CPU tensor, rows cut to m.
    cut = cb.band_matmul(band_t, v_t, m=nb * r - 3)
    assert torch.equal(cut, got[: nb * r - 3])


def _families():
    def spill(g, csr_cls):
        b = g.banded_csr(200, 4, 3, seed=133)
        rnd = g.random_csr(200, 200, 250, seed=134)
        return csr_cls.from_dense(np.asarray(b.to_dense())
                                  + np.asarray(rnd.to_dense()))

    return {
        "plain-k1": (lambda g, c: g.banded_csr(300, 7, 5, seed=131), 1),
        "plain-k8": (lambda g, c: g.banded_csr(300, 7, 5, seed=131), 8),
        "plain-k32": (lambda g, c: g.banded_csr(300, 7, 5, seed=131), 32),
        "spill": (spill, 5),
        "odd-rows": (lambda g, c: g.banded_csr(101, 3, 2, seed=136), 3),
        "unaligned-k6": (lambda g, c: g.banded_csr(300, 7, 5, seed=141), 6),
        "unaligned-k12": (lambda g, c: g.banded_csr(300, 7, 5, seed=141), 12),
    }


def _from_dense(dense):
    coo_i, coo_j = np.nonzero(dense)
    from sparsematrixmultiplicationmpi_tpu_torch.formats.matrix import COO

    return COO.from_arrays(dense[coo_i, coo_j], coo_i, coo_j,
                           dense.shape).to_csr()


@pytest.mark.parametrize("family", list(_families()))
def test_spmm_banded_cuda_cpu_path_matches_pallas(family):
    make, k = _families()[family]
    t_csr_cls = types.SimpleNamespace(from_dense=_from_dense)
    jcsr = make(JG, JCSR).astype(jnp.float32)
    tcsr = make(TG, t_csr_cls).astype(np.float32)
    jb = JB.BandedBlocks.from_csr(jcsr, block_rows=8)
    tb = TB.BandedBlocks.from_csr(tcsr, block_rows=8)
    np.testing.assert_array_equal(np.asarray(jb.band), tb.band)
    assert (jb.spill is None) == (tb.spill is None) == (family != "spill")
    m = tcsr.shape[0]
    v = JG.generate_fat_vector(m, k, seed=132).astype(np.float32)
    want = np.asarray(spmm_banded_pallas(jb, jnp.asarray(v), interpret=True))
    got = cb.spmm_banded_cuda(tb.to("cpu"), torch.from_numpy(v))
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, k)
    abs_csr = CSR(values=np.abs(tcsr.values), col_indices=tcsr.col_indices,
                  row_ptr=tcsr.row_ptr, shape=tcsr.shape)
    cond = spmm_host_f64(abs_csr, np.abs(v))
    _assert_close(got.numpy(), want, cond)
    oracle = spmm_host_f64(tcsr, v)
    rel = np.max(np.abs(got.numpy() - oracle) / np.maximum(np.abs(oracle), 1))
    assert rel < 1e-4


def test_kernel_route_casts_v_to_the_band_dtype():
    """Like ``spmm_banded_pallas``, the kernel route returns the band's
    dtype; the plain route keeps a 32/64-bit ``v``'s."""
    csr = TG.banded_csr(300, 7, 5, seed=131).astype(np.float32)
    bb = TB.BandedBlocks.from_csr(csr, block_rows=8).to("cpu")
    v = torch.from_numpy(TG.generate_fat_vector(300, 4, seed=1))  # f64
    assert cb.spmm_banded_cuda(bb, v).dtype == torch.float32
    assert TA.spmm_banded(bb, v).dtype == torch.float64
    half = bb.astype(torch.bfloat16)
    assert cb.spmm_banded_cuda(half, v.float()).dtype == torch.bfloat16


def _jax_and_port_band(**kw):
    jcsr = JG.banded_csr(3000, 150, 10, seed=5).astype(jnp.float32)
    tcsr = TG.banded_csr(3000, 150, 10, seed=5).astype(np.float32)
    return (JB.BandedBlocks.from_csr(jcsr, **kw),
            TB.BandedBlocks.from_csr(tcsr, **kw), tcsr)


@pytest.mark.parametrize("kw", [dict(block_rows=128), dict(block_rows=64)],
                         ids=["r128", "r64-spill"])
def test_banded_blocks_dtype_dense_and_matmul_match_jax(kw):
    jb, tb, tcsr = _jax_and_port_band(**kw)
    assert (tb.spill is None) == (jb.spill is None)
    assert tb.dtype == torch.float32
    assert tb.dense_bytes == jb.dense_bytes == tb.band.nbytes
    np.testing.assert_array_equal(tb.to_dense(), np.asarray(jb.to_dense()))
    np.testing.assert_array_equal(tb.to_dense(), tcsr.to_dense())
    v = JG.generate_fat_vector(3000, 5, seed=9).astype(np.float32)
    got = (tb.to("cpu") @ torch.from_numpy(v)).numpy()
    want = np.asarray(jb @ jnp.asarray(v))
    abs_csr = CSR(values=np.abs(tcsr.values), col_indices=tcsr.col_indices,
                  row_ptr=tcsr.row_ptr, shape=tcsr.shape)
    _assert_close(got, want, spmm_host_f64(abs_csr, np.abs(v)))


def test_banded_blocks_astype_matches_jax_bits():
    jb, tb, _ = _jax_and_port_band(block_rows=64)
    assert tb.spill is not None
    jh, th = jb.astype(jnp.bfloat16), tb.astype(torch.bfloat16)
    assert th.dtype == torch.bfloat16 and th.band.dtype == np.uint16
    np.testing.assert_array_equal(
        np.asarray(jh.band).view(np.uint16), th.band)
    for jbk, tbk in zip(jh.spill.buckets, th.spill.buckets):
        np.testing.assert_array_equal(np.asarray(jbk.vals).view(np.uint16),
                                      tbk.vals)
    assert th.dense_bytes == tb.dense_bytes // 2
    # On a device copy the cast stays there; back to f32 is exact.
    dev = th.to("cpu")
    assert dev.band.dtype == torch.bfloat16 and dev.dtype == torch.bfloat16
    back = dev.astype(np.float32)
    assert back.band.dtype == torch.float32
    np.testing.assert_array_equal(
        back.band.numpy(), np.asarray(jh.band.astype(jnp.float32)))


def test_spmm_any_band_routes(monkeypatch):
    """CPU -> spmm_banded; CUDA -> B5 up to block_rows 128, the batched
    matmuls above; any other device raises."""
    calls = []
    monkeypatch.setattr(cb, "spmm_banded_cuda",
                        lambda bb, v: calls.append(("B5", bb.block_rows)))
    monkeypatch.setattr(TA, "spmm_banded",
                        lambda bb, v: calls.append(("plain", bb.block_rows)))
    narrow, wide = (TB.BandedBlocks(band=np.zeros((1, r, 3 * r)),
                                    spill=None, shape=(r, r), block_rows=r)
                    for r in (128, 256))
    cuda_v = types.SimpleNamespace(device=torch.device("cuda", 0))
    cpu_v = torch.zeros((4, 2))
    TA.spmm_any(narrow, cuda_v)
    TA.spmm_any(wide, cuda_v)
    TA.spmm_any(narrow, cpu_v)
    assert calls == [("B5", 128), ("plain", 256), ("plain", 128)]
    with pytest.raises(ValueError, match="no band route"):
        TA.spmm_any(wide, torch.empty((4, 2), device="meta"))


def test_band_matmul_rejects_bad_shapes_and_devices():
    band = torch.zeros((2, 8, 24))
    with pytest.raises(ValueError, match=r"\(nb, r, 3r\)"):
        cb.band_matmul(torch.zeros((2, 8, 16)), torch.zeros((16, 2)))
    with pytest.raises(ValueError, match=r"\(n, k\)"):
        cb.band_matmul(band, torch.zeros(16))
    with pytest.raises(ValueError, match="outside"):
        cb.band_matmul(band, torch.zeros((16, 2)), m=17)
    with pytest.raises(ValueError, match="no kernel for a tensor on meta"):
        cb.band_matmul(band.to("meta"), torch.zeros((16, 2), device="meta"))


def test_cpu_path_never_launches():
    cb.reset_launch_counts()
    band = torch.from_numpy(_band(2, 8, seed=3))
    cb.band_matmul(band, torch.ones((16, 3)))
    assert cb.launch_counts() == {"B5": 0}


def test_library_builds_every_source_with_one_nvcc_each(monkeypatch,
                                                         tmp_path):
    """One ``nvcc -c`` per ``csrc/*.cu``, one link, and a file name keyed
    by every source."""
    log = tmp_path / "calls.log"
    fake = tmp_path / "nvcc"
    fake.write_text(
        "#!/bin/sh\n"
        f'echo "$@" >> {log}\n'
        'while [ "$#" -gt 0 ]; do\n'
        '  if [ "$1" = "-o" ]; then touch "$2"; fi\n'
        "  shift\n"
        "done\n")
    fake.chmod(0o755)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    real = sorted(os.listdir(_kernel_lib.CSRC_DIR))
    assert {"banded_kernels.cu", "windowed_kernels.cu"} <= set(real)
    for name in real:
        (csrc / name).write_bytes(
            open(os.path.join(_kernel_lib.CSRC_DIR, name), "rb").read())
    monkeypatch.setattr(_kernel_lib, "CSRC_DIR", str(csrc))
    monkeypatch.setattr(_kernel_lib, "BUILD_DIR", str(tmp_path / "build"))
    first = _kernel_lib._build(str(fake))
    calls = log.read_text().splitlines()
    compiles = [c for c in calls if " -c " in f" {c} "]
    assert sorted(c.split()[-1] for c in compiles) == \
        sorted(str(csrc / n) for n in real)
    assert all("arch=compute_90a,code=sm_90a" in c for c in calls)
    links = [c for c in calls if "-shared" in c.split()]
    assert len(links) == 1 and len(calls) == len(real) + 1
    assert os.path.basename(first).startswith("libkernels_")
    assert not [f for f in os.listdir(tmp_path / "build") if f.endswith(".o")]
    assert _kernel_lib._build(str(fake)) == first  # unchanged: cached
    (csrc / "banded_kernels.cu").write_text("// edited\n")
    assert _kernel_lib._build(str(fake)) != first
