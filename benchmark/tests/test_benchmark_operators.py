"""A configuration's generator and operator found by name: the two
configurations' operators bit for bit as before the lookup by file, a
configuration whose stand-in and normalisation exist only as new files
run end to end, and the error for a name that is neither in the dicts
nor a file."""

import hashlib
import json
import os
import textwrap

import numpy as np
import pytest

from benchmark.core.cells import BENCH_DIR, load_cell
from benchmark.core.harness import run_cell
from benchmark.reference import operators
from test_benchmark_loops import FAULTS, fault_wrap

#: SHA-256 of each array of ``operator(config, seed)`` at full scale, taken
#: when the generators and normalisations were still looked up in the dicts
#: alone.
DIGESTS = {
    ("cop20k_A", 1): {
        "values": "8ad6df242f0ab4e35d339f61461a25754bdcd31e19a52ce19aeef1e04a55df5f",
        "col_indices": "3912d0af6a582e0a56375bb37c0e81d394e630c0bb52ecad8838b0245bc0df8c",
        "row_ptr": "a9cb55243c979643358d18268bc2be9f07aaca8a6c1a8b5fdb5132ca116c90c7"},
    ("cop20k_A", 2): {
        "values": "a4507e9a4188da546f7f158ca60f8ee49bc1953c835d076da7ab2938e0f106ac",
        "col_indices": "370a5d93abc365653aaf527d9170f77ab5e40177b9506a7c01434425a92f2cae",
        "row_ptr": "f1609011a9839a63314cc56cb75af2e4cb8238c68a4827bf8647d3c29447adf4"},
    ("amazon0302", 1): {
        "values": "f9c493e48fbe1908dcc3cc9ec143d6ba5ef94a4d74ce14aad3bb7741a04bdb74",
        "col_indices": "2243acb290a2b248bb8bf106b7305af30c4463377d03b0890b1049cd697b9748",
        "row_ptr": "5143968037fd5a32b57461615035fd3d06e934beefe96f1d3f589fc885c8ff91"},
    ("amazon0302", 2): {
        "values": "c00492cd144cef9670497d19e9e37457bf7b8ffa673f15a547461aded748ddd2",
        "col_indices": "31b10526a6d03cab9e4b85b72585cd800d518f5a7d475567f4c7329f3f2faa7d",
        "row_ptr": "9031c9522d2ad3663d8f5b1906d7347f8b4f72d68b78319492ee92446ec8ff7a"},
}
SHAPES = {"cop20k_A": (121_192, 121_192), "amazon0302": (262_111, 262_111)}


@pytest.mark.parametrize("config,seed", sorted(DIGESTS))
def test_existing_operators_are_unchanged(config, seed):
    with open(os.path.join(BENCH_DIR, "configs", f"{config}.json")) as f:
        a = operators.operator(json.load(f), seed)
    assert a.shape == SHAPES[config]
    assert (a.values.dtype, a.col_indices.dtype, a.row_ptr.dtype) == (
        np.float64, np.int32, np.int32)
    got = {k: hashlib.sha256(getattr(a, k).tobytes()).hexdigest()
           for k in DIGESTS[config, seed]}
    assert got == DIGESTS[config, seed]


#: A symmetric band of positive entries whose diagonal makes every row sum
#: to the same constant: strictly diagonally dominant, so SPD.
BANDED_SPD = '''
import numpy as np

from benchmark.reference.generate import Csr, _build


def generate(seed, dtype, scale):
    rng = np.random.default_rng(seed)
    m, half = max(int(600 * scale), 16), 3
    i = np.repeat(np.arange(m), half)
    j = i + np.tile(np.arange(1, half + 1), m)
    i, j = i[j < m], j[j < m]
    off = rng.uniform(0.5, 1.0, size=i.size)
    row_off = np.bincount(i, off, m) + np.bincount(j, off, m)
    diag = 2 * row_off.max() + 1 - row_off
    d = np.arange(m)
    return _build(np.concatenate([i, j, d]), np.concatenate([j, i, d]),
                  np.concatenate([off, off, diag]).astype(dtype), m, m)
'''

#: ``A`` over its largest absolute row sum: for a matrix of positive
#: entries whose rows sum alike, spectral radius 1, so a fed-back chain
#: neither grows nor fades.
INF_NORM_SCALED = '''
import numpy as np


def normalise(a):
    vals = a.values.astype(np.float64)
    rows = np.repeat(np.arange(a.shape[0]), np.diff(a.row_ptr))
    return a._replace(values=vals / np.bincount(rows, np.abs(vals)).max())
'''


@pytest.fixture
def files_only(tmp_path, monkeypatch):
    """The lookups pointed at directories that hold only the new files,
    and the cell ``chain_k32``'s loop on a configuration that names them."""
    gens, norms = tmp_path / "generators", tmp_path / "normalisations"
    gens.mkdir()
    norms.mkdir()
    (gens / "banded_spd.py").write_text(textwrap.dedent(BANDED_SPD))
    (norms / "inf_norm_scaled.py").write_text(textwrap.dedent(INF_NORM_SCALED))
    monkeypatch.setattr(operators, "GENERATOR_DIR", str(gens))
    monkeypatch.setattr(operators, "NORMALISATION_DIR", str(norms))
    cell = load_cell("cop20k_A.chain_k32")
    cell.config = {"name": "banded_spd", "generator": "banded_spd",
                   "scale": 1.0, "pattern_seed": 0, "relabel": "permutation",
                   "operator": "inf_norm_scaled", "dtype": "float32"}
    cell.traffic["sample_range"] = [3, 40]
    return cell


def test_the_new_files_make_an_spd_operator(files_only):
    raw = operators.find_generator("banded_spd")(0, np.float64, 1.0)
    dense = operators.as_scipy(raw).toarray()
    np.testing.assert_array_equal(dense, dense.T)
    assert np.linalg.eigvalsh(dense).min() > 0
    op = operators.as_scipy(operators.operator(files_only.config, 5))
    np.testing.assert_allclose(np.asarray(op.sum(axis=1)).ravel(), 1.0,
                               rtol=1e-12)


def test_a_configuration_added_as_files_runs(files_only):
    res = run_cell(files_only, 2**31 + 7, 1.0, False, "cpu",
                   log=lambda *a: None)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    broken = run_cell(files_only, 2**31 + 7, 1.0, False, "cpu",
                      wrap=fault_wrap("chain", FAULTS["unchanged"]),
                      log=lambda *a: None)
    assert not broken["correct"], broken["checks"]


@pytest.fixture
def empty_dirs(tmp_path, monkeypatch):
    """The lookups pointed at empty directories, so that the names refused
    stay refused whatever files later configurations add."""
    dirs = {}
    for kind, attr in (("generators", "GENERATOR_DIR"),
                       ("normalisations", "NORMALISATION_DIR")):
        dirs[kind] = tmp_path / kind
        dirs[kind].mkdir()
        (dirs[kind] / "__init__.py").write_text('"""A package."""\n')
        monkeypatch.setattr(operators, attr, str(dirs[kind]))
    return dirs


@pytest.mark.parametrize("find,table,directory", [
    ("find_generator", "reference/generate.py::GENERATORS", "generators"),
    ("find_normalisation", "reference/operators.py::NORMALISATIONS",
     "normalisations")])
@pytest.mark.parametrize("name", ["dc1_like", "../generate", "a/b",
                                  "generate.py", "", "1st", "__init__",
                                  "_helper"])
def test_an_unknown_or_path_like_name_is_refused(empty_dirs, find, table,
                                                 directory, name):
    with pytest.raises(ValueError) as err:
        getattr(operators, find)(name)
    msg = str(err.value)
    assert table in msg and repr(name) in msg
    assert str(empty_dirs[directory]) in msg
    if name == "dc1_like":
        assert str(empty_dirs[directory] / "dc1_like.py") in msg


@pytest.mark.parametrize("table,directory", [
    ("GENERATORS", operators.GENERATOR_DIR),
    ("NORMALISATIONS", operators.NORMALISATION_DIR)])
def test_no_file_shadows_a_name_of_the_dicts(table, directory):
    """The dicts are looked in first, so a file named like one of their
    entries would never be loaded."""
    dicts = {"GENERATORS": operators.GENERATORS,
             "NORMALISATIONS": operators.NORMALISATIONS}
    files = {f[:-3] for f in os.listdir(directory) if f.endswith(".py")}
    assert not files & set(dicts[table])


def test_a_normalisation_that_moves_the_pattern_is_refused(files_only,
                                                           tmp_path):
    (tmp_path / "normalisations" / "drops_one.py").write_text(textwrap.dedent(
        '''
        def normalise(a):
            return a._replace(values=a.values[:-1])
        '''))
    files_only.config["operator"] = "drops_one"
    with pytest.raises(ValueError, match="drops_one"):
        operators.operator(files_only.config, 1)
