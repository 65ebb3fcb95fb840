"""The port's public surface against the JAX package's, on the CPU: the
Sequential and dense oracles on the JAX package's own test cases
(``tests/test_ops.py``, ``tests/test_edge_cases.py``), the one-shot
``spmm``, every name of the JAX package's top-level, ``ops``,
``formats`` and ``utils`` ``__all__`` (in its order, the port's library
names in place of BCOO), ``native_dir``; the host bf16 split's bits on
non-finite values against the JAX split, in the split itself and in a
windowed build; the narrow-k routing decision (``_takes_kernels``),
which sends every k through the kernels on the card and keeps the
reference's gate on the CPU; the kernels a multiply on each format
launches on the card (``ops/auto.py::route_kernels``) and the models
benchmark's launch check; and member-level parity: every public
function, class, method, property, field and parameter of every JAX
module exists in the port's module of the same path, but for an
allow-list (``PARITY_DIVERGENCES``) that ``ROADMAP.md`` repeats.
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
import sparsematrixmultiplicationmpi_tpu_torch.ops.auto as TOA
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


# ---- the kernels a route launches on the card ---------------------------

def _route_cases():
    """(label, host operand, k, the kernels one multiply on its card
    copy launches)."""
    from sparsematrixmultiplicationmpi_tpu_torch.formats.hub import (
        HubExtracted,
    )

    pl = TG.powerlaw_csr(2000, 2000, 20000, seed=7).astype(np.float32)
    band = TG.banded_csr(400, 6, 4, seed=3).astype(np.float32)

    def wp(U, R=128, **kw):
        return TW.WindowedPairs.from_csr(
            pl, block_rows=R, chunk_cols=128, pairs_per_step=U,
            beat_gather_margin=np.inf, **kw)

    u16 = wp(16)
    return [
        ("COO", pl.to_coo(), 32, ()),
        ("BucketedELL", TF.BucketedELL.from_csr(pl), 32, ("B7",)),
        ("BucketedELL-k256", TF.BucketedELL.from_csr(pl), 256, ()),
        ("band-128", TF.BandedBlocks.from_csr(band, block_rows=128), 8,
         ("B5",)),
        ("band-256", TF.BandedBlocks.from_csr(band, block_rows=256), 8, ()),
        ("U16-spill", u16, 32, ("B2", "B1", "B7")),
        ("U16-spill-k1", u16, 1, ("B2", "B1", "B7")),
        ("U16-R16-spill", wp(16, R=16), 32, ("B7",)),
        ("U2-f32", wp(2), 32, ("B2", "B3", "B7")),
        ("U2-bf16", wp(2).astype(torch.bfloat16), 32, ("B2", "B4", "B7")),
        ("hub", HubExtracted(dense_cols=np.zeros((2000, 1), np.float32),
                             hub_ids=np.zeros(1, np.int32), remainder=u16,
                             shape=pl.shape), 32, ("B2", "B1", "B7")),
    ]


def test_route_kernels_by_format():
    for label, op, k, want in _route_cases():
        assert TOA.route_kernels(op, k) == want, label


def test_route_kernels_of_a_phase_layout_is_b6():
    csr = TG.banded_csr(512, 24, 8, seed=51).astype(np.float32)
    wp = TW.WindowedPairs.from_csr(
        csr, block_rows=128, chunk_cols=128, pairs_per_step=16,
        reorder=None, beat_gather_margin=1e9, max_inflation=1e9,
        phase_layout=True)
    assert wp.phases is not None and wp.spill is None
    assert TOA.route_kernels(wp, 32) == ("B2", "B6")


@pytest.mark.parametrize("route,per,launches,calls,ok", [
    ((), {"B1": 0, "B7": 0}, {"B1": 0, "B7": 0}, 5, True),
    ((), {"B1": 0, "B7": 1}, {"B1": 0, "B7": 5}, 5, False),
    ((), {"B1": 0, "B7": 0}, {"B1": 0, "B7": 1}, 5, False),
    (("B7",), {"B1": 0, "B7": 1}, {"B1": 0, "B7": 5}, 5, True),
    (("B7",), {"B1": 0, "B7": 1}, {"B1": 0, "B7": 6}, 5, False),
    (("B7",), {"B1": 0, "B7": 0}, {"B1": 0, "B7": 0}, 5, False),
    (("B2", "B1"), {"B1": 1, "B2": 1, "B7": 1},
     {"B1": 5, "B2": 5, "B7": 5}, 5, True),
], ids=["coo-none", "coo-launched", "coo-stray", "b7", "b7-extra",
        "b7-missing", "b1-b2-with-spill"])
def test_models_bench_holds_launches_to_the_route(route, per, launches,
                                                   calls, ok):
    """``run_models_bench``'s launch check: a route with kernels launches
    each of them, exactly one multiply's per call; a route with none (COO)
    launches nothing."""
    from sparsematrixmultiplicationmpi_tpu_torch.scripts import (
        run_models_bench,
    )

    assert run_models_bench._launched_per_multiply(
        launches, per, calls, route) is ok


# ---- member-level parity ------------------------------------------------

#: Every place where the port's surface departs from the JAX package's,
#: with its reason. A key names a module of the JAX package that the
#: port does not have (``utils/backend.py``), a public function or class
#: missing from the port's module of the same path (``file::name``), the
#: public members missing from a class (``file::Class.{a, b}``) or the
#: parameters missing from a function or method (``file::fn(a, b)``).
#: ``ROADMAP.md``'s "Divergences by design" lists the same keys.
PARITY_DIVERGENCES = {
    "utils/backend.py": "it probes JAX's backend for Mosaic interpret "
    "mode; in the port each route follows its tensors' device",
    "ops/pallas_windowed.py": "the Pallas kernels B1-B4 and B6; the port's "
    "are CUDA C++ in csrc/windowed_kernels.cu, bound in "
    "ops/cuda_windowed.py",
    "ops/pallas_banded.py": "the Pallas band kernel B5; the port's is "
    "csrc/banded_kernels.cu, bound in ops/cuda_banded.py",
    "ops/pallas_gather.py": "the Pallas gather kernel B7; the port's is "
    "csrc/gather_kernels.cu, bound in ops/cuda_gather.py",
    "ops/_gather_calib.py": "the gather records; the port keeps them in "
    "formats/_gather_calib.py beside the card's (_gather_calib_h100.py), "
    "where the cost tables read them",
    "ops/library.py::to_bcoo": "BCOO is JAX's; ported as to_torch_sparse",
    "ops/library.py::spmm_bcoo": "BCOO is JAX's; ported as spmm_library",
    "utils/collectives.py::compiled_hlo": "the port counts bytes around "
    "its collectives instead of parsing HLO",
    "utils/collectives.py::collective_stats(hlo_text)": "the counts are "
    "the collectives' own, so there is no HLO text to read",
    "io/mtx.py::read_matrix_market(use_native)": "the native parser where "
    "it builds, else numpy; read_matrix_market_numpy is the explicit "
    "numpy reader",
    "ops/auto.py::spmm_any(use_pallas)": "the route follows v's device: "
    "CUDA tensors take the kernels, CPU tensors their plain versions",
    "ops/windowed.py::spmm_windowed(use_pallas)": "the route follows v's "
    "device, as spmm_any's",
    "ops/windowed.py::spmm_windowed_core(use_pallas)": "the route follows "
    "v_p's device, as spmm_any's",
    "ops/windowed.py::windowed_t_chain(interpret)": "Pallas interpret mode "
    "has no counterpart: the chain follows the operand's device",
    "models/gcn.py::init_gcn(key)": "a torch.Generator (generator=) in "
    "place of a JAX PRNG key",
    "models/gat.py::init_gat(key)": "a torch.Generator (generator=) in "
    "place of a JAX PRNG key",
    "parallel/mesh.py::make_mesh(devices, axis_name)": "a process group "
    "(n_devices, device) in place of a jax.sharding.Mesh of devices and "
    "named axes",
    "parallel/mesh.py::make_mesh_2d(devices, axis_names)": "a process "
    "group split into rows and columns (n_row, n_col, device)",
    "parallel/mesh.py::initialize_distributed(**kwargs)": "torch."
    "distributed takes its rank, world size and address explicitly "
    "(rank, world_size, init_method, device)",
    "parallel/windowed_strategy.py::WindowedRowOperand.{block_ptr, "
    "pair_chunk, pair_pos, tiles, tiles_split}": "a rank holds its "
    "share as one WindowedPairs (pairs: tiles, tiles_split, pair_chunk, "
    "pair_block, block_ptr)",
    "utils/profiling.py::trace(create_perfetto_link)": "torch.profiler "
    "writes a Chrome trace (log_dir/trace.json); there is no Perfetto "
    "link to make",
    "utils/timing.py::time_fn(*args, **kwargs)": "time_fn(fn, device) "
    "times a closure on a device's clock (CUDA events on the card) "
    "instead of a jitted function's arguments",
    "utils/timing.py::measure_amortized(calibrate)": "the chain's slope "
    "between two lengths is always taken: eager calls have no "
    "per-dispatch envelope to calibrate away",
    "utils/timing.py::time_fn_amortized(calibrate)": "as "
    "measure_amortized",
}

JAX_ROOT = J.__name__


def _jax_modules():
    import pkgutil

    return [JAX_ROOT] + [m.name for m in pkgutil.walk_packages(
        J.__path__, JAX_ROOT + ".")]


def _path(mod_name: str) -> str:
    """The JAX module's file, relative to its package."""
    rel = mod_name[len(JAX_ROOT):].lstrip(".").replace(".", "/")
    import importlib

    is_pkg = hasattr(importlib.import_module(mod_name), "__path__")
    return f"{rel}/__init__.py".lstrip("/") if is_pkg else f"{rel}.py"


def _public_members(cls) -> set:
    """A class's public methods, properties, attributes and dataclass
    fields, its bases' within either package included."""
    names = set()
    for klass in cls.__mro__:
        if klass.__module__.split(".")[0] in (JAX_ROOT, T.__name__):
            names.update(n for n in vars(klass) if not n.startswith("_"))
    if dataclasses.is_dataclass(cls):
        names.update(f.name for f in dataclasses.fields(cls)
                     if not f.name.startswith("_"))
    return names


def _missing_params(jfn, tfn) -> list:
    import inspect

    try:
        jps = inspect.signature(jfn).parameters.values()
        tps = inspect.signature(tfn).parameters
    except (TypeError, ValueError):
        return []
    star = {inspect.Parameter.VAR_POSITIONAL: "*",
            inspect.Parameter.VAR_KEYWORD: "**"}
    return [star.get(p.kind, "") + p.name for p in jps
            if p.name not in tps and p.name not in ("self", "cls")]


def _gaps(mod_name: str) -> set:
    """The keys of every place where the port departs from the JAX
    module ``mod_name`` (see ``PARITY_DIVERGENCES``)."""
    import importlib
    import inspect

    jmod = importlib.import_module(mod_name)
    path = _path(mod_name)
    port_name = T.__name__ + mod_name[len(JAX_ROOT):]
    try:
        tmod = importlib.import_module(port_name)
    except ModuleNotFoundError as e:
        if e.name != port_name:
            raise
        return {path}
    gaps = set()
    for name in getattr(jmod, "__all__", []):
        if not hasattr(tmod, RENAMES.get(name, name)):
            obj = getattr(jmod, name)
            where = getattr(obj, "__module__", mod_name)
            gaps.add(f"{_path(where)}::{name}")
    for name, obj in vars(jmod).items():
        if name.startswith("_") or not (
                inspect.isfunction(obj) or inspect.isclass(obj)) or (
                obj.__module__ != mod_name):
            continue
        if not hasattr(tmod, name):
            gaps.add(f"{path}::{name}")
            continue
        tobj = getattr(tmod, name)
        if inspect.isfunction(obj):
            missing = _missing_params(obj, tobj)
            if missing:
                gaps.add(f"{path}::{name}({', '.join(missing)})")
            continue
        tmembers = _public_members(tobj)
        absent = [m for m in sorted(_public_members(obj))
                  if m not in tmembers]
        if absent:
            gaps.add(f"{path}::{name}.{{{', '.join(absent)}}}")
        for member in sorted(_public_members(obj) & tmembers):
            jm = inspect.getattr_static(obj, member, None)
            if isinstance(jm, (classmethod, staticmethod)):
                jm = jm.__func__
            if inspect.isfunction(jm):
                missing = _missing_params(jm, getattr(tobj, member))
                if missing:
                    gaps.add(f"{path}::{name}.{member}"
                             f"({', '.join(missing)})")
    return gaps


@pytest.mark.parametrize("mod_name", _jax_modules())
def test_every_jax_member_exists_in_the_port(mod_name):
    """Each public function and class of the JAX module, each public
    method, property and field of its classes, each parameter of its
    functions and methods, and each name of its ``__all__`` exists in the
    port's module of the same path, but for ``PARITY_DIVERGENCES``."""
    unlisted = _gaps(mod_name) - set(PARITY_DIVERGENCES)
    assert not unlisted, f"the port lacks {sorted(unlisted)}"


def test_parity_allow_list_holds_only_divergences():
    """Every allow-list entry is still a gap: an entry goes when the port
    gains what it names."""
    found = set().union(*(_gaps(m) for m in _jax_modules()))
    assert set(PARITY_DIVERGENCES) - found == set()


def test_parity_allow_list_is_the_roadmaps():
    """``ROADMAP.md``'s allow-list (the indented ``- `key`:`` lines under
    "The parity test's allow-list") names the same entries."""
    import pathlib
    import re

    text = (pathlib.Path(__file__).resolve().parents[1]
            / "ROADMAP.md").read_text()
    start = text.index("**The parity test's allow-list**")
    block = text[start:].split("\n- ", 1)[0]
    listed = [re.sub(r"\s+", " ", key) for key in
              re.findall(r"^  - `([^`]+)`:", block, re.M)]
    assert len(listed) == len(set(listed))
    assert set(listed) == set(PARITY_DIVERGENCES)
