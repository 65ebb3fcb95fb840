"""Parity of the PyTorch port's host-side foundation with the JAX package:
generators, Matrix Market I/O, the sparse containers, the comparator and
the oracles. Host-side builders must match bit for bit; the torch COO
SpMM matches within the f32 tier.

Both packages are imported here; data passes between them as numpy with
explicit dtypes (``tests/conftest.py`` turns JAX's x64 mode on).
"""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sparsematrixmultiplicationmpi_tpu.formats.matrix as JM
import sparsematrixmultiplicationmpi_tpu.io.generate as JG
import sparsematrixmultiplicationmpi_tpu.io.mtx as JX
import sparsematrixmultiplicationmpi_tpu.ops.oracle as JO
import sparsematrixmultiplicationmpi_tpu.utils.compare as JC
import sparsematrixmultiplicationmpi_tpu_torch.formats.matrix as TM
import sparsematrixmultiplicationmpi_tpu_torch.io.generate as TG
import sparsematrixmultiplicationmpi_tpu_torch.io.mtx as TX
import sparsematrixmultiplicationmpi_tpu_torch.ops.oracle as TO
import sparsematrixmultiplicationmpi_tpu_torch.utils.compare as TC

GENERATORS = [
    ("random_csr", dict(m=300, n=200, nnz=2000, seed=1)),
    ("banded_csr", dict(m=400, bandwidth=12, nnz_per_row=6, seed=2)),
    ("powerlaw_csr", dict(m=300, n=300, nnz=3000, seed=3)),
    ("fem3d_csr", dict(m=512, target_nnz=8192, seed=4)),
    ("fem3d_csr", dict(m=1000, target_nnz=20000, seed=5, shuffle=False)),
    ("cop20k_like", dict(scale=0.02, seed=6)),
    ("cage4_like", {}),
    ("roadnet_like", dict(scale=0.002, seed=7)),
    ("amazon0302_like", dict(scale=0.005, seed=8)),
    ("dc1_like", dict(scale=0.005, seed=9)),
]


def _csr_equal(a, b):
    assert a.shape == b.shape
    for f in ("values", "col_indices", "row_ptr"):
        x, y = np.asarray(getattr(a, f)), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


def _gen(mod, name, kw, dtype=np.float64):
    fn = getattr(mod, name)
    return fn(**kw) if name == "cage4_like" else fn(dtype=dtype, **kw)


@pytest.mark.parametrize("name,kw", GENERATORS,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(GENERATORS)])
def test_generators_bit_identical(name, kw):
    _csr_equal(_gen(JG, name, kw), _gen(TG, name, kw))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_generator_dtype_and_fat_vector(dtype):
    _csr_equal(JG.fem3d_csr(256, 4096, seed=0, dtype=dtype),
               TG.fem3d_csr(256, 4096, seed=0, dtype=dtype))
    np.testing.assert_array_equal(
        JG.generate_fat_vector(100, 7, seed=3, dtype=dtype),
        TG.generate_fat_vector(100, 7, seed=3, dtype=dtype))


@pytest.mark.parametrize("symmetric,pattern", [(False, False), (True, False),
                                               (False, True)])
def test_matrix_market_round_trip(tmp_path, symmetric, pattern):
    csr = TG.fem3d_csr(200, 2400, seed=11)
    if pattern:
        csr = dataclasses.replace(csr, values=np.ones_like(csr.values))
    path = str(tmp_path / "m.mtx")
    TX.write_matrix_market(path, csr, symmetric=symmetric, pattern=pattern)
    got = TX.read_matrix_market(path)
    _csr_equal(JX.read_matrix_market_numpy(path), got)
    np.testing.assert_array_equal(got.to_dense(), csr.to_dense())


def test_matrix_market_errors(tmp_path):
    with pytest.raises(FileNotFoundError):
        TX.read_matrix_market(str(tmp_path / "missing.mtx"))
    bad = tmp_path / "bad.mtx"
    bad.write_text("%%MatrixMarket matrix coordinate complex general\n1 1 1\n")
    with pytest.raises(ValueError, match="complex"):
        TX.read_matrix_market(str(bad))


FAMILIES = {
    "fem3d": lambda g: g.fem3d_csr(600, 9000, seed=12),
    "powerlaw": lambda g: g.powerlaw_csr(500, 500, 6000, seed=13),
    "random": lambda g: g.random_csr(400, 300, 3000, seed=14),
    "banded": lambda g: g.banded_csr(500, 20, 7, seed=15),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_ell_and_bucketed_builders_bit_identical(family):
    jc, tc = FAMILIES[family](JG), FAMILIES[family](TG)
    je, te = JM.ELL.from_csr(jc, width_align=4), TM.ELL.from_csr(
        tc, width_align=4)
    np.testing.assert_array_equal(np.asarray(je.cols), te.cols)
    np.testing.assert_array_equal(np.asarray(je.vals), te.vals)
    for kw in ({}, dict(width_align=2, max_buckets=16)):
        jb, tb = JM.BucketedELL.from_csr(jc, **kw), TM.BucketedELL.from_csr(
            tc, **kw)
        assert len(jb.buckets) == len(tb.buckets)
        for b1, b2 in zip(jb.buckets, tb.buckets):
            assert tuple(b1.shape) == tuple(b2.shape)
            np.testing.assert_array_equal(np.asarray(b1.cols), b2.cols)
            np.testing.assert_array_equal(np.asarray(b1.vals), b2.vals)
        np.testing.assert_array_equal(np.asarray(jb.row_perm), tb.row_perm)
        np.testing.assert_array_equal(np.asarray(jb.inv_row_perm),
                                      tb.inv_row_perm)
    np.testing.assert_array_equal(np.asarray(JM.BucketedELL.from_csr(
        jc).to_dense()), TM.BucketedELL.from_csr(tc).to_dense())


def test_coalesce_split_and_row_take_bit_identical():
    rng = np.random.default_rng(16)
    i = rng.integers(0, 50, 400)
    j = rng.integers(0, 60, 400)
    v = rng.uniform(-1, 1, 400).astype(np.float32)
    for a, b in zip(JM.coalesce_coo(i, j, v, 60), TM.coalesce_coo(i, j, v,
                                                                  60)):
        np.testing.assert_array_equal(a, b)
    jc, tc = JG.powerlaw_csr(300, 300, 5000, seed=17), TG.powerlaw_csr(
        300, 300, 5000, seed=17)
    (jh, jt), (th, tt) = (JM.split_csr_by_width(jc, 8),
                          TM.split_csr_by_width(tc, 8))
    _csr_equal(jh, th)
    for f in ("values", "row_indices", "col_indices"):
        np.testing.assert_array_equal(np.asarray(getattr(jt, f)),
                                      getattr(tt, f))
    rows = np.array([5, 0, 299, 17])
    _csr_equal(JM._csr_take_rows(jc, rows), TM._csr_take_rows(tc, rows))
    _csr_equal(JM.COO.from_arrays(v, i, j, (50, 60)).to_csr(),
               TM.COO.from_arrays(v, i, j, (50, 60)).to_csr())


def test_comparator_verbatim():
    rng = np.random.default_rng(18)
    a = rng.normal(size=(30, 4))
    b = a + rng.normal(scale=1e-4, size=a.shape)
    cond = np.abs(a) * 3
    for kw in ({}, dict(tolerance=1e-3), dict(tolerance=5e-3, relative=True),
               dict(tolerance=1e-5, relative=True, condition_scale=cond)):
        assert JC.are_matrices_equal(a, b, **kw) == \
            TC.are_matrices_equal(a, b, **kw)
    assert JC.max_abs_error(a, b) == TC.max_abs_error(a, b)
    for dt in (np.float64, np.float32, np.float16):
        assert JC.default_tolerance(np.dtype(dt)) == \
            TC.default_tolerance(np.dtype(dt))


def test_host_oracle_bit_identical():
    csr = TG.fem3d_csr(300, 4000, seed=19, dtype=np.float32)
    v = TG.generate_fat_vector(300, 5, seed=20)
    np.testing.assert_array_equal(JO.spmm_host_f64(csr, v),
                                  TO.spmm_host_f64(csr, v))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_spmm_coo_matches_jax_and_oracle(dtype):
    jc = JG.powerlaw_csr(400, 300, 5000, seed=21, dtype=dtype)
    tc = TG.powerlaw_csr(400, 300, 5000, seed=21, dtype=dtype)
    v = TG.generate_fat_vector(300, 6, seed=22, dtype=dtype)
    got = TO.spmm_coo(tc.to_coo().to("cpu"), torch.from_numpy(v)).numpy()
    ref_jax = np.asarray(JO.spmm_coo(jc.to_coo(), jnp.asarray(v, dtype)))
    oracle = TO.spmm_host_f64(tc, v)
    tol = TC.default_tolerance(np.dtype(dtype))
    rel = dtype == np.float32
    assert TC.are_matrices_equal(got, oracle, tolerance=tol, relative=rel)
    assert TC.are_matrices_equal(got, ref_jax, tolerance=tol, relative=rel)


def test_to_device_makes_tensors():
    csr = TG.fem3d_csr(100, 900, seed=23, dtype=np.float32)
    moved = csr.to("cpu")
    assert isinstance(moved.values, torch.Tensor)
    assert moved.values.dtype == torch.float32
    assert moved.col_indices.dtype == torch.int32
    bits = np.array([0x3F80, 0xC000], dtype=np.uint16)  # bf16 1.0, -2.0
    t = TM.to_tensor(bits, "cpu")
    assert t.dtype == torch.bfloat16 and t.float().tolist() == [1.0, -2.0]


def test_port_never_imports_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import sparsematrixmultiplicationmpi_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules\n"
        "             if n == 'jax' or n.startswith(('jax.', 'jaxlib'))\n"
        "             or n.startswith('sparsematrixmultiplicationmpi_tpu.')\n"
        "             or n == 'sparsematrixmultiplicationmpi_tpu')\n"
        "assert not bad, bad\n"
        "print('ok', len(list(pkgutil.walk_packages(p.__path__))))\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=root)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")
