"""The port's bindings to the repository's host C++ (``io/native.py``,
``formats/native_split.py``) on the CPU: the native Matrix Market parser
against the JAX package's native and numpy loaders and the port's numpy
loader on general, symmetric, skew-symmetric and pattern files (generated
here: ``tests/fixtures`` holds no ``.mtx``) and on a file large enough
for the parser's threads; missing and truncated files; the f32 -> bf16
hi|lo split bit for bit against the JAX package's native split and
torch's cast; the build in ``build/native``. Exact comparisons: both
sides parse the same text and cast the same floats.
"""

import os

import numpy as np
import pytest
import torch

from sparsematrixmultiplicationmpi_tpu.formats.native_split import (
    split_bf16_hilo_native as jax_split,
)
import sparsematrixmultiplicationmpi_tpu.io.native as jax_native
from sparsematrixmultiplicationmpi_tpu.io.mtx import (
    read_matrix_market_numpy as jax_numpy_reader,
)
import sparsematrixmultiplicationmpi_tpu_torch.formats.native_split as ns
import sparsematrixmultiplicationmpi_tpu_torch.io.generate as TG
import sparsematrixmultiplicationmpi_tpu_torch.io.native as native
from sparsematrixmultiplicationmpi_tpu_torch.formats.matrix import CSR
from sparsematrixmultiplicationmpi_tpu_torch.formats.windowed import (
    _split_planes,
)
from sparsematrixmultiplicationmpi_tpu_torch.io.mtx import (
    read_matrix_market, read_matrix_market_numpy, write_matrix_market,
)


@pytest.fixture
def built():
    if not (native.available() and ns.available()
            and jax_native.available()):
        pytest.skip("no C++ compiler to build native/*.cpp")


def _assert_same_csr(a, b):
    assert tuple(a.shape) == tuple(b.shape)
    for x, y in ((a.row_ptr, b.row_ptr), (a.col_indices, b.col_indices),
                 (a.values, b.values)):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def _general():
    return TG.random_csr(60, 45, 400, seed=91), {}


def _symmetric():
    d = TG.random_csr(40, 40, 200, seed=92).to_dense()
    return CSR.from_dense(d + d.T), {"symmetric": True}


def _pattern():
    csr = TG.powerlaw_csr(50, 50, 300, seed=93)
    return CSR.from_arrays(np.ones(csr.nnz), csr.col_indices, csr.row_ptr,
                           csr.shape), {"pattern": True}


FILES = {"general": _general, "symmetric": _symmetric, "pattern": _pattern}


@pytest.mark.parametrize("kind", sorted(FILES))
def test_native_parser_matches_every_loader(tmp_path, built, kind):
    csr, kw = FILES[kind]()
    path = str(tmp_path / "m.mtx")
    write_matrix_market(path, csr, **kw)
    got = native.read_matrix_market_native(path)
    _assert_same_csr(got, read_matrix_market_numpy(path))
    _assert_same_csr(got, jax_native.read_matrix_market_native(path))
    _assert_same_csr(got, jax_numpy_reader(path))
    if kind != "pattern":
        np.testing.assert_array_equal(got.to_dense(), csr.to_dense())


def test_native_parser_skew_symmetric(tmp_path, built):
    path = tmp_path / "skew.mtx"
    path.write_text("%%MatrixMarket matrix coordinate real skew-symmetric\n"
                    "% a comment line\n3 3 2\n2 1 1.5\n3 2 -0.25\n")
    got = native.read_matrix_market_native(str(path))
    _assert_same_csr(got, read_matrix_market_numpy(str(path)))
    _assert_same_csr(got, jax_native.read_matrix_market_native(str(path)))
    assert got.to_dense()[0, 1] == -1.5 and got.to_dense()[1, 2] == 0.25


@pytest.mark.parametrize("n_threads", [1, 4])
def test_native_parser_threads(tmp_path, built, n_threads):
    """A body over 1 MiB takes the parser's threaded path."""
    csr = TG.random_csr(2000, 2000, 60_000, seed=94)
    path = str(tmp_path / "big.mtx")
    write_matrix_market(path, csr)
    assert os.path.getsize(path) > 1 << 20
    got = native.read_matrix_market_native(path, n_threads=n_threads)
    _assert_same_csr(got, read_matrix_market_numpy(path))
    _assert_same_csr(got, jax_native.read_matrix_market_native(
        path, n_threads=n_threads))


def test_native_parser_dtype(tmp_path, built):
    csr, _ = _general()
    path = str(tmp_path / "m.mtx")
    write_matrix_market(path, csr)
    got = native.read_matrix_market_native(path, dtype=np.float32)
    _assert_same_csr(got, read_matrix_market_numpy(path, dtype=np.float32))


def test_native_missing_file(built):
    with pytest.raises(FileNotFoundError):
        native.read_matrix_market_native("/no/such/file.mtx")
    with pytest.raises(FileNotFoundError):
        read_matrix_market("/no/such/file.mtx")


def test_native_truncated(tmp_path, built):
    p = tmp_path / "bad.mtx"
    p.write_text("%%MatrixMarket matrix coordinate real general\n"
                 "3 3 5\n1 1 2.0\n")
    with pytest.raises(ValueError):
        native.read_matrix_market_native(str(p))
    with pytest.raises(ValueError):
        read_matrix_market(str(p))


def test_read_matrix_market_takes_native(tmp_path, built, monkeypatch):
    csr, _ = _general()
    path = str(tmp_path / "m.mtx")
    write_matrix_market(path, csr)
    calls = []
    real = native.read_matrix_market_native
    monkeypatch.setattr(native, "read_matrix_market_native",
                        lambda *a, **k: calls.append(a) or real(*a, **k))
    _assert_same_csr(read_matrix_market(path), csr)
    assert len(calls) == 1
    _assert_same_csr(read_matrix_market_numpy(path), csr)
    assert len(calls) == 1


def test_native_builds_in_build_dir(built):
    """The port builds into ``build/native`` (a name keyed by the
    source's hash), never next to the source where the JAX package
    builds its own."""
    for name in ("mmio", "tilesplit"):
        lib = native.build_native(name)
        assert os.path.dirname(lib) == native.BUILD_DIR
        assert os.path.basename(lib).startswith(f"lib{name}_")
    assert native.build_native("no_such_source") is None


def _split_inputs():
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((77, 130))
         * np.exp(rng.uniform(-60, 60, (77, 130)))).astype(np.float32)
    x[0, :8] = [0.0, -0.0, 1e-40, -1e-40, 3.3e38, -3.3e38, 1.0, 2 ** -133]
    return x


def _torch_split(x):
    t = torch.from_numpy(x)
    hi = t.to(torch.bfloat16)
    lo = (t - hi.to(torch.float32)).to(torch.bfloat16)
    return torch.cat([hi, lo], -1).view(torch.int16).numpy().view(np.uint16)


def test_native_split_bit_for_bit(built):
    """The split against the JAX package's native split and torch's cast,
    on finite values over the whole exponent range, signed zeros and
    subnormals included; in a 3-D tile array too."""
    x = _split_inputs()
    got = ns.split_bf16_hilo_native(x)
    assert got.dtype == np.uint16 and got.shape == (77, 260)
    np.testing.assert_array_equal(got, jax_split(x).view(np.uint16))
    np.testing.assert_array_equal(got, _torch_split(x))
    tiles = x[:76].reshape(4, 19, 130)
    np.testing.assert_array_equal(ns.split_bf16_hilo_native(tiles),
                                  _torch_split(tiles))


def test_split_nan_stays_nan(built):
    x = np.array([[np.nan, np.inf, -np.inf, 1.0]], np.float32)
    got = ns.split_bf16_hilo_native(x)
    as_f32 = (got.astype(np.uint32) << 16).view(np.float32)
    want = (_torch_split(x).astype(np.uint32) << 16).view(np.float32)
    np.testing.assert_array_equal(np.isnan(as_f32), np.isnan(want))
    np.testing.assert_array_equal(as_f32[~np.isnan(as_f32)],
                                  want[~np.isnan(want)])


def test_split_planes_native_equals_torch(built):
    """``_split_planes`` (torch's cast, the only split on the build path)
    gives the native split's bits on finite values."""
    tiles = _split_inputs()[:76].reshape(4, 19, 130)
    np.testing.assert_array_equal(_split_planes(tiles),
                                  ns.split_bf16_hilo_native(tiles))
    assert _split_planes(tiles.astype(np.float64)) is None
