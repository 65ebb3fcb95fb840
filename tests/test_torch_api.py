"""The port's public surface against the JAX package's, on the CPU: the
Sequential and dense oracles on the JAX package's own test cases
(``tests/test_ops.py``, ``tests/test_edge_cases.py``), the one-shot
``spmm``, every name of the JAX package's top-level, ``ops``,
``formats`` and ``utils`` ``__all__`` (in its order, the port's library
names in place of BCOO), ``native_dir``; the host bf16 split's bits on
non-finite values against the JAX split, in the split itself and in a
windowed build; and the narrow-k routing decision (``_takes_kernels``),
which sends every k through the kernels on the card and keeps the
reference's gate on the CPU.
"""

import dataclasses

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import sparsematrixmultiplicationmpi_tpu as J
import sparsematrixmultiplicationmpi_tpu.formats as JF
import sparsematrixmultiplicationmpi_tpu.formats.windowed as JW
import sparsematrixmultiplicationmpi_tpu.io.generate as JG
import sparsematrixmultiplicationmpi_tpu.io.native as JN
import sparsematrixmultiplicationmpi_tpu.ops as JO
import sparsematrixmultiplicationmpi_tpu.ops.windowed as JOW
import sparsematrixmultiplicationmpi_tpu.utils as JU
from sparsematrixmultiplicationmpi_tpu.formats.native_split import (
    split_bf16_hilo_native as jax_native_split,
)
import sparsematrixmultiplicationmpi_tpu_torch as T
import sparsematrixmultiplicationmpi_tpu_torch.formats as TF
import sparsematrixmultiplicationmpi_tpu_torch.formats.windowed as TW
import sparsematrixmultiplicationmpi_tpu_torch.io.generate as TG
import sparsematrixmultiplicationmpi_tpu_torch.io.native as TN
import sparsematrixmultiplicationmpi_tpu_torch.ops as TO
import sparsematrixmultiplicationmpi_tpu_torch.ops.windowed as TOW
import sparsematrixmultiplicationmpi_tpu_torch.utils as TU
from sparsematrixmultiplicationmpi_tpu_torch.utils.compare import (
    are_matrices_equal, default_tolerance,
)

MATRICES = {  # tests/test_ops.py's, built by either package's generators
    "cage4_like": lambda g, C: g.cage4_like(),
    "random": lambda g, C: g.random_csr(120, 90, 1000, seed=1),
    "banded": lambda g, C: g.banded_csr(200, 9, 7, seed=2),
    "powerlaw": lambda g, C: g.powerlaw_csr(150, 150, 2500, seed=3),
    "roadnet_like": lambda g, C: g.roadnet_like(scale=0.002, seed=4),
    "dc1_like": lambda g, C: g.dc1_like(scale=0.005, seed=5),
    "single_row": lambda g, C: C.from_dense(np.ones((1, 64))),
    "single_col": lambda g, C: C.from_dense(np.ones((64, 1))),
    "with_empty_rows": lambda g, C: C.from_dense(
        np.diag([1.0, 0, 0, 2.0, 0, 3.0, 0, 0])),
}
KS = [1, 3, 12]


def _pair(name):
    return MATRICES[name](JG, J.CSR), MATRICES[name](TG, T.CSR)


def _dense_oracle(csr, v):
    return np.asarray(csr.to_dense()) @ np.asarray(v)


@pytest.mark.parametrize("name", MATRICES)
@pytest.mark.parametrize("k", KS)
def test_spmm_sequential(name, k):
    jc, tc = _pair(name)
    v = TG.generate_fat_vector(tc.shape[1], k, seed=5)
    got = T.spmm_sequential(tc, torch.from_numpy(v)).numpy()
    want = np.asarray(J.spmm_sequential(jc, jnp.asarray(v)))
    assert got.shape == (tc.shape[0], k)
    assert T.max_abs_error(got, _dense_oracle(tc, v)) < 1e-9
    assert T.max_abs_error(got, want) < 1e-9


def test_dense_oracle_matches_numpy():
    jc, tc = _pair("random")
    v = TG.generate_fat_vector(tc.shape[1], 2, seed=15)
    got = T.spmm_dense(tc, torch.from_numpy(v)).numpy()
    assert T.max_abs_error(got, _dense_oracle(tc, v)) < 1e-9
    assert T.max_abs_error(got, np.asarray(J.spmm_dense(jc, jnp.asarray(v)))
                           ) < 1e-9


def test_dense_oracle_casts_to_the_vector_dtype():
    tc = MATRICES["random"](TG, T.CSR).astype(np.float32)
    v = torch.from_numpy(TG.generate_fat_vector(tc.shape[1], 3, seed=16))
    assert T.spmm_dense(tc, v).dtype == torch.float64
    assert T.spmm_dense(tc, v.float()).dtype == torch.float32


def _empty(C, m=6, n=5):
    return C.from_arrays(np.zeros(0), np.zeros(0, np.int32),
                         np.zeros(m + 1, np.int32), (m, n))


@pytest.mark.parametrize("case", ["empty", "one_by_one", "scalar_k",
                                  "f32_values_f64_vector", "int_vector"])
def test_spmm_sequential_edge_cases(case):
    """``tests/test_edge_cases.py``'s ``spmm_sequential`` cases through
    both packages."""
    if case == "empty":
        jc, tc = _empty(J.CSR), _empty(T.CSR)
        v = TG.generate_fat_vector(5, 3, seed=181)
    elif case == "one_by_one":
        jc = J.CSR.from_dense(np.array([[2.5]]))
        tc = T.CSR.from_dense(np.array([[2.5]]))
        v = np.array([[3.0, 4.0]])
    elif case == "scalar_k":
        jc, tc = (g.random_csr(20, 20, 100, seed=184) for g in (JG, TG))
        v = TG.generate_fat_vector(20, 1, seed=185)
    elif case == "f32_values_f64_vector":
        jc, tc = (g.random_csr(10, 10, 40, seed=186).astype(np.float32)
                  for g in (JG, TG))
        v = TG.generate_fat_vector(10, 2, seed=187)
    else:
        jc, tc = (g.random_csr(8, 8, 20, seed=188) for g in (JG, TG))
        v = TG.generate_fat_vector(8, 2, seed=189).astype(np.int32).astype(
            np.float64)
    got = T.spmm_sequential(tc, torch.from_numpy(v))
    want = np.asarray(J.spmm_sequential(jc, jnp.asarray(v)))
    assert tuple(got.shape) == want.shape
    assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
    assert T.max_abs_error(got.numpy(), want) < 1e-10
    assert T.max_abs_error(got.numpy(), _dense_oracle(tc, v)) < 1e-10
    if case == "empty":
        assert float(got.abs().max()) == 0.0


#: JAX names the port carries under another name (the library yardstick).
RENAMES = {"to_bcoo": "to_torch_sparse", "spmm_bcoo": "spmm_library"}


@pytest.mark.parametrize("jax_mod,port_mod", [
    (J, T), (JO, TO), (JF, TF), (JU, TU)],
    ids=["top-level", "ops", "formats", "utils"])
def test_public_names_hold_the_jax_ones(jax_mod, port_mod):
    want = [RENAMES.get(name, name) for name in jax_mod.__all__]
    assert port_mod.__all__[:len(want)] == want
    assert len(set(port_mod.__all__)) == len(port_mod.__all__)
    for name in port_mod.__all__:
        assert hasattr(port_mod, name), name


def test_native_dir_is_the_repository_native_sources():
    assert TN.native_dir() == JN.native_dir()
    assert "native_dir" in TN.__all__


@pytest.mark.parametrize("make", [
    lambda g: g.banded_csr(600, 20, 8, seed=21),
    lambda g: g.powerlaw_csr(300, 300, 3000, seed=22),
    lambda g: g.random_csr(200, 150, 1500, seed=23),
], ids=["banded", "powerlaw", "random"])
def test_one_shot_spmm_matches_jax(make):
    jc, tc = make(JG).astype(np.float32), make(TG).astype(np.float32)
    v = TG.generate_fat_vector(tc.shape[1], 8, seed=24).astype(np.float32)
    got = TO.spmm(tc, torch.from_numpy(v)).numpy()
    want = np.asarray(JO.spmm(jc, jnp.asarray(v)))
    oracle = T.spmm_host_f64(tc, v)
    tol = default_tolerance(np.float32)
    assert are_matrices_equal(got, oracle, tolerance=tol, relative=True)
    assert are_matrices_equal(got, want, tolerance=tol, relative=True)


# ---- the host split's bits on non-finite values -------------------------

#: Canonical and signalling NaNs with a payload, as uint32 bits.
PAYLOAD_NANS = np.array([0x7F800001, 0xFFA00000, 0x7FC12345],
                        np.uint32).view(np.float32)
NONFINITE = np.array([1.0, np.inf, -np.inf, np.nan, -np.nan, 3.4e38,
                      -3.4e38, -0.0, 1e-40, -1e-40, 1e-45, 3.3895314e38,
                      2.5], np.float32)


def _ml_dtypes_split(x):
    """The JAX package's fallback split (ml_dtypes), as uint16 bits."""
    hi = x.astype(ml_dtypes.bfloat16)
    with np.errstate(invalid="ignore"):
        lo = (x - hi.astype(np.float32)).astype(ml_dtypes.bfloat16)
    return np.concatenate([hi, lo], axis=-1).view(np.uint16)


@pytest.mark.parametrize("payload", [False, True],
                         ids=["canonical", "payload-nans"])
def test_split_planes_nonfinite_bits(payload):
    x = np.concatenate([NONFINITE, PAYLOAD_NANS]) if payload else NONFINITE
    x = np.tile(x, (2, 3, 1))
    got = TW._split_planes(x)
    with np.errstate(invalid="ignore"):
        np.testing.assert_array_equal(got, _ml_dtypes_split(x))
    native = jax_native_split(x)
    if native is None:
        pytest.skip("the JAX package's native split does not build here")
    native = native.view(np.uint16)
    if not payload:
        np.testing.assert_array_equal(got, native)
    else:
        # The one divergence: the native split keeps a NaN's payload.
        differ = got != native
        as_f32 = (got.astype(np.uint32) << 16).view(np.float32)
        assert differ.any() and np.isnan(as_f32[differ]).all()
        assert ((got[differ] & 0x7FFF) == 0x7FC0).all()


def test_windowed_build_with_nonfinite_values_matches_jax_bitwise():
    """A matrix holding ±Inf and NaN: ``tiles_split`` and ``tiles_t`` of
    the port's build bit for bit those of the JAX package's."""
    kw = dict(block_rows=128, pairs_per_step=8, chunk_cols=128,
              reorder=None, beat_gather_margin=1e9, max_inflation=1e9)
    mats = []
    for g in (JG, TG):
        csr = g.banded_csr(512, 24, 8, seed=4).astype(np.float32)
        vals = np.array(csr.values, copy=True)
        vals[[3, 50, 700, 1500, 2900]] = [np.inf, -np.inf, np.nan,
                                          -np.nan, 3.4e38]
        mats.append(dataclasses.replace(csr, values=vals))
    jw = JW.WindowedPairs.from_csr(mats[0], **kw)
    tw = TW.WindowedPairs.from_csr(mats[1], **kw)
    for field in ("tiles_split", "tiles_t"):
        want = np.asarray(getattr(jw, field)).view(np.uint16)
        got = getattr(tw, field)
        assert got.dtype == np.uint16 and got.shape == want.shape
        np.testing.assert_array_equal(got, want, err_msg=field)
    assert (tw.tiles_split & 0x7FFF > 0x7F80).any()  # NaN halves present


# ---- narrow unaligned k on the card -------------------------------------

def _host_operand(U):
    csr = TG.banded_csr(512, 24, 8, seed=4).astype(np.float32)
    return TW.WindowedPairs.from_csr(
        csr, block_rows=128, chunk_cols=128, pairs_per_step=U, reorder=None,
        beat_gather_margin=1e9, max_inflation=1e9)


@pytest.mark.parametrize("U", [16, 2])
def test_narrow_k_takes_the_kernels_on_the_card_only(U):
    wp = _host_operand(U)
    for k in (1, 3, 6, 9):
        assert TOW._takes_kernels(wp, k, "cuda")
        assert TOW._takes_kernels(wp, k, torch.device("cuda", 0))
        assert not TOW._takes_kernels(wp, k, "cpu")
    for k in (8, 12, 16, 32):  # the reference's gate holds on the CPU
        assert TOW._takes_kernels(wp, k, "cpu")
        assert TOW._takes_kernels(wp, k, "cuda")


def test_narrow_k_gates_on_the_operand_not_the_width():
    """U > 2 without transposed planes of ``R % 128 == 0`` stays on the
    plain path on the card at every k."""
    csr = TG.fem3d_csr(256, 4096, seed=0).astype(np.float32)
    r16 = TW.WindowedPairs.from_csr(
        csr, block_rows=16, pairs_per_step=8, chunk_cols=128, reorder=None,
        beat_gather_margin=1e9, max_inflation=1e9)
    for k in (1, 8, 32):
        assert not TOW._takes_kernels(r16, k, "cuda")


def test_narrow_k_chain_is_none_on_the_cpu_as_in_jax():
    tw = _host_operand(16)
    kw = dict(block_rows=128, chunk_cols=128, pairs_per_step=16,
              reorder=None, beat_gather_margin=1e9, max_inflation=1e9)
    jw = JW.WindowedPairs.from_csr(
        JG.banded_csr(512, 24, 8, seed=4).astype(np.float32), **kw)
    for k in (1, 3, 6, 9):
        assert TOW.windowed_t_chain(tw, k) is None
        assert JOW.windowed_t_chain(jw, k) is None
    # Off the CPU the same operand chains at k = 1, padded to 8.
    assert TOW.windowed_t_chain(tw.to("meta"), 1) is not None


def test_narrow_k_on_the_cpu_stays_on_the_plain_path():
    """The CPU result at k = 1 is the plain gather path's, bit for bit."""
    wp = _host_operand(16).to("cpu")
    v = torch.from_numpy(TG.generate_fat_vector(512, 1, seed=3).astype(
        np.float32))
    v_p = wp.encode(v)
    assert torch.equal(TOW.spmm_windowed_core(wp, v_p),
                       TOW.spmm_windowed_xla(wp, v_p))
