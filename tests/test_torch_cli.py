"""The port's command line (``cli.py``) on the CPU (``--device cpu``):
``run`` on a ``.mtx`` and a synthetic matrix with its phrase lines, JSON
and CSV; ``info``; ``convert`` and ``reorder``; ``run`` on a prepared
format; the three error probes (rc 1, ``spmm: error:`` on stderr); a card
run where there is no CUDA; ``run`` on two spawned ranks; and the JAX
CLI and the port's printing the same phrase lines (numbers masked) and
JSON keys for the same ``.mtx`` at ``--devices 1``. The CLI module
imports no JAX.
"""

import json
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from sparsematrixmultiplicationmpi_tpu.cli import main as jax_cli_main
from sparsematrixmultiplicationmpi_tpu_torch.cli import main as cli_main
from sparsematrixmultiplicationmpi_tpu_torch.formats.reorder import (
    apply_symmetric_permutation, bandwidth,
)
from sparsematrixmultiplicationmpi_tpu_torch.formats.serialize import (
    load_format,
)
from sparsematrixmultiplicationmpi_tpu_torch.io.generate import (
    banded_csr, random_csr,
)
from sparsematrixmultiplicationmpi_tpu_torch.io.mtx import (
    read_matrix_market, write_matrix_market,
)

FAST = ["--iters", "1", "--warmup", "1"]
CPU = ["--device", "cpu"] + FAST


def _mtx(tmp_path, csr, name="m.mtx"):
    path = str(tmp_path / name)
    write_matrix_market(path, csr)
    return path


def test_cli_run(tmp_path, capsys):
    csr = random_csr(50, 50, 300, seed=54)
    path = _mtx(tmp_path, csr)
    rc = cli_main(["run", path, "--k", "4", "--dtype", "float64", *CPU,
                   "--json", str(tmp_path / "r.json"),
                   "--csv", str(tmp_path / "r.csv")])
    assert rc == 0
    out = capsys.readouterr().out
    for phrase in ("World size: 1", f"Sparse matrix: {path}",
                   "Matrix size: 50x50", "Vector size: 50x4",
                   f"Non-zero elements: {csr.nnz}", "Load time:",
                   "Serial Algo Execution time:", "Row-wise Execution time:",
                   "Row-wise: Results are the same!",
                   "Column-wise: Results are the same!",
                   "Non-zero Elements: Results are the same!",
                   "Library: Results are the same!",
                   "Auto: Results are the same!"):
        assert phrase in out, phrase
    payload = json.loads((tmp_path / "r.json").read_text())
    assert payload["nnz"] == csr.nnz and payload["devices"] == 1
    assert len(payload["records"]) == 5
    assert all(r["correct"] and r["device_kind"] == "cpu"
               for r in payload["records"])
    with open(tmp_path / "r.csv") as f:
        assert len(f.readlines()) == 6


def test_cli_run_synthetic(capsys):
    rc = cli_main(["run", "synthetic:cage4", "--k", "3", "--dtype",
                   "float64", *CPU, "--strategy", "row,nnz",
                   "--json", "-"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Row-wise: Results are the same!" in out
    assert "Non-zero Elements: Results are the same!" in out
    payload = json.loads(out.strip().splitlines()[-1])
    assert [r["strategy"] for r in payload["records"]] == ["row_wise", "nnz"]


def test_cli_run_amortized_float32(capsys):
    rc = cli_main(["run", "synthetic:cage4", "--k", "8", *CPU,
                   "--strategy", "auto", "--amortized"])
    assert rc == 0
    assert "Auto: Results are the same!" in capsys.readouterr().out


def test_cli_info(capsys):
    assert cli_main(["info"]) == 0
    out = capsys.readouterr().out
    assert f"devices: {torch.cuda.device_count()}" in out
    assert "process group: none" in out
    assert f"CUDA {torch.version.cuda}" in out


def test_reorder_command(tmp_path, capsys):
    csr = banded_csr(150, 5, 4, seed=161)
    scrambled = apply_symmetric_permutation(
        csr, np.random.default_rng(162).permutation(150))
    src, dst = _mtx(tmp_path, scrambled, "in.mtx"), str(tmp_path / "o.mtx")
    assert cli_main(["reorder", src, dst]) == 0
    assert "bandwidth" in capsys.readouterr().out
    reordered = read_matrix_market(dst)
    assert bandwidth(reordered) < bandwidth(scrambled)
    assert reordered.nnz == scrambled.nnz


def test_convert_command(tmp_path, capsys):
    csr = banded_csr(100, 4, 3, seed=163)
    src, dst = _mtx(tmp_path, csr), str(tmp_path / "m.npz")
    assert cli_main(["convert", src, dst, "--format", "banded",
                     "--block-rows", "8", "--dtype", "float64"]) == 0
    assert "BandedBlocks" in capsys.readouterr().out
    obj = load_format(dst)
    assert type(obj).__name__ == "BandedBlocks" and obj.block_rows == 8
    np.testing.assert_array_equal(obj.to_dense(), csr.to_dense())


@pytest.mark.parametrize("fmt", ["coo", "bucketed"])
def test_convert_formats(tmp_path, fmt):
    csr = banded_csr(100, 4, 3, seed=163)
    dst = str(tmp_path / "m.npz")
    assert cli_main(["convert", _mtx(tmp_path, csr), dst, "--format", fmt,
                     "--dtype", "float64", "--rcm"]) == 0
    assert load_format(dst).shape == csr.shape


def test_convert_auto_to_a_windowed_pick_is_an_error(tmp_path, capsys):
    """``auto`` picks ``WindowedPairs`` here, which no package can save:
    an error message, not a traceback."""
    dst = str(tmp_path / "m.npz")
    assert cli_main(["convert", "synthetic:cage4", dst]) == 1
    assert "WindowedPairs" in capsys.readouterr().err


def test_convert_csr_then_run(tmp_path, capsys):
    csr = banded_csr(60, 3, 2, seed=164)
    dst = str(tmp_path / "m.npz")
    assert cli_main(["convert", _mtx(tmp_path, csr), dst, "--format", "csr",
                     "--dtype", "float64"]) == 0
    assert cli_main(["run", dst, "--k", "2", "--strategy", "row",
                     "--dtype", "float64", *CPU]) == 0
    assert "Results are the same!" in capsys.readouterr().out


@pytest.mark.parametrize("fmt,amortized", [("banded", False),
                                           ("banded", True),
                                           ("bucketed", False)])
def test_run_prepared_format(tmp_path, capsys, fmt, amortized):
    csr = banded_csr(60, 3, 2, seed=165)
    dst = str(tmp_path / "m.npz")
    extra = ["--block-rows", "8"] if fmt == "banded" else []
    assert cli_main(["convert", _mtx(tmp_path, csr), dst, "--format", fmt,
                     *extra]) == 0
    rc = cli_main(["run", dst, "--k", "2", "--dtype", "float64", *CPU]
                  + (["--amortized"] if amortized else []))
    assert rc == 0
    out = capsys.readouterr().out
    assert ("BandedBlocks" if fmt == "banded" else "BucketedELL") in out
    assert "Auto Execution time:" in out
    assert "oracle comparison unavailable" in out or "< " in out


@pytest.mark.parametrize("argv", [
    ["run", "/no/such/matrix.mtx"],
    ["run", "synthetic:bogus"],
    ["run", "synthetic:cage4", "--strategy", "bogus"],
])
def test_error_probes(capsys, argv):
    assert cli_main(argv + ["--device", "cpu"]) == 1
    err = capsys.readouterr().err
    assert err.startswith("spmm: error: ")


def test_card_run_without_cuda_stops(capsys):
    """Without CUDA, a card run (the default) exits non-zero with a
    message and runs nothing on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the card run would run")
    assert cli_main(["run", "synthetic:cage4", "--k", "3"]) == 1
    captured = capsys.readouterr()
    assert "torch.cuda.is_available() is False" in captured.err
    assert "World size" not in captured.out
    assert cli_main(["sweep", "synthetic:cage4", "--k", "1"]) == 1


def test_cli_module_imports_no_jax():
    code = ("import sys\n"
            "import sparsematrixmultiplicationmpi_tpu_torch.cli\n"
            "import sparsematrixmultiplicationmpi_tpu_torch.bench.report\n"
            "import sparsematrixmultiplicationmpi_tpu_torch.bench.plots\n"
            "import sparsematrixmultiplicationmpi_tpu_torch.io.native\n"
            "import sparsematrixmultiplicationmpi_tpu_torch.formats."
            "native_split\n"
            "import sparsematrixmultiplicationmpi_tpu_torch.formats."
            "serialize\n"
            "sparsematrixmultiplicationmpi_tpu_torch.cli.main(['info'])\n"
            "assert 'jax' not in sys.modules, 'jax imported'\n"
            "assert not any(m.startswith('sparsematrixmultiplicationmpi_tpu.')"
            " for m in sys.modules)\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "devices:" in res.stdout


def _masked_lines(out: str):
    """Stdout lines with every number masked."""
    return [re.sub(r"\d+(\.\d+)?(e[-+]?\d+)?", "#", line)
            for line in out.strip().splitlines()]


def test_phrase_lines_and_json_keys_match_the_jax_cli(tmp_path, capsys):
    csr = random_csr(40, 40, 250, seed=55)
    path = _mtx(tmp_path, csr)
    common = ["run", path, "--k", "4", "--dtype", "float64", "--devices",
              "1", *FAST]
    assert jax_cli_main(common + ["--json", str(tmp_path / "j.json")]) == 0
    theirs = capsys.readouterr().out
    assert cli_main(common + ["--device", "cpu",
                              "--json", str(tmp_path / "t.json")]) == 0
    ours = capsys.readouterr().out
    assert _masked_lines(ours) == _masked_lines(theirs)
    assert ours.count("Results are the same!") == 5
    j = json.loads((tmp_path / "j.json").read_text())
    t = json.loads((tmp_path / "t.json").read_text())
    assert list(t) == list(j)
    assert [list(r) for r in t["records"]] == [list(r) for r in j["records"]]
    assert [r["strategy"] for r in t["records"]] == \
        [r["strategy"] for r in j["records"]]
    assert [r["correct"] for r in t["records"]] == \
        [r["correct"] for r in j["records"]]


def test_cli_run_on_two_spawned_ranks(capfd):
    """``--devices 2`` with no process group spawns two gloo ranks; rank 0
    alone prints."""
    rc = cli_main(["run", "synthetic:cage4", "--k", "3", "--dtype",
                   "float64", "--devices", "2", *CPU,
                   "--strategy", "row,nnz"])
    assert rc == 0
    out = capfd.readouterr().out
    assert out.count("World size: 2") == 1
    assert out.count("Row-wise: Results are the same!") == 1
    assert out.count("Non-zero Elements: Results are the same!") == 1
