"""``BENCHMARK.json`` against the contract's shape, every file it names
found by name, the forbidden modules, and the run without a card."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from benchmark.core.cells import BENCH_DIR, ROOT, load_cell, reader_path
from benchmark.core.harness import FORBIDDEN, forbidden_modules

SPEC = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_names_units_and_files():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and os.path.isfile(os.path.join(ROOT, c["file"]))
        cfg = json.load(open(os.path.join(ROOT, c["file"])))
        assert cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] == 1 and len(w["why"]) <= 200
        assert os.path.isfile(os.path.join(BENCH_DIR, "traffic", w["traffic"] + ".json"))
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert os.path.isfile(reader_path(m["name"]))


@pytest.mark.parametrize("c", [c["name"] for c in SPEC["configs"]])
def test_every_configuration_resolves_its_generator_and_operator(c):
    from benchmark.reference.operators import (find_generator,
                                               find_normalisation)

    entry = next(e for e in SPEC["configs"] if e["name"] == c)
    cfg = json.load(open(os.path.join(ROOT, entry["file"])))
    assert callable(find_generator(cfg["generator"]))
    assert callable(find_normalisation(cfg["operator"]))


@pytest.mark.parametrize("w", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_reports_setup_another_metric_and_a_layer(w):
    cell = load_cell(w)
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    # Each per-layer metric's moved metric is one this cell reports.
    assert all(m["moves"] in names for m in cell.per_layer)
    assert set(cell.traffic["limits"])


def test_forbidden_names_are_compared_whole():
    assert forbidden_modules(["sparsematrixmultiplicationmpi_tpu_torch.ops",
                              "numpy", "jaxtyping"]) == []
    assert forbidden_modules(["sparsematrixmultiplicationmpi_tpu.ops.auto",
                              "jax.numpy", "flax"]) == [
        "flax", "jax", "sparsematrixmultiplicationmpi_tpu"]
    assert "jaxlib" in FORBIDDEN


SCRIPT = r"""
import sys
sys.path.insert(0, {root!r})
from benchmark.core.cells import load_cell
from benchmark.core.harness import run_cell, forbidden_modules
cell = load_cell("cop20k_A.chain_k32")
cell.config["scale"] = 0.01
cell.traffic["sample_range"] = [3, 40]
res = run_cell(cell, 3, 1.0, True, "cpu", log=lambda *a: None)
assert res["correct"]
print("FOUND", forbidden_modules())
"""


def test_a_run_loads_neither_jax_nor_the_jax_package():
    p = subprocess.run([sys.executable, "-c", SCRIPT.format(root=ROOT)],
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert "FOUND []" in p.stdout


REF_SCRIPT = r"""
import os, sys
sys.path.insert(0, {root!r})
import numpy as np
from benchmark.reference import chain, pagerank, control, operators, generate
from benchmark.reference import generators, normalisations
cfg = {{"generator": "amazon0302_top5", "scale": 0.01, "pattern_seed": 0,
       "relabel": "cyclic_shift", "operator": "column_stochastic_abs"}}
a = operators.as_scipy(operators.operator(cfg, 4))
kept, deltas, stop = pagerank.power_iteration(a, 0.85, 1e-9, 100, keep=(3,))
assert 3 in kept and stop > 3
# Every generator and normalisation that a configuration may name as a file,
# run, so that an import inside ``generate`` or ``normalise`` shows too: each
# generator at a small scale, each normalisation on every stand-in's matrix.
# A file whose name starts with ``_`` is a helper, loaded by what imports it.
def named(d):
    return [f[:-3] for f in sorted(os.listdir(d))
            if f.endswith(".py") and not f.startswith("_")]
mats = [gen(seed=0, dtype=np.float64, scale=0.01)
        for gen in generate.GENERATORS.values()]
for name in named(operators.GENERATOR_DIR):
    mats.append(operators.find_generator(name)(0, np.float64, 0.01))
for name in named(operators.NORMALISATION_DIR):
    normalise = operators.find_normalisation(name)
    for m in mats:
        normalise(m)
bad = sorted(m for m in sys.modules
             if m.split(".")[0].startswith("sparsematrixmultiplicationmpi_tpu")
             or m.split(".")[0] in ("jax", "jaxlib", "flax"))
print("BAD", bad)
"""


def test_the_reference_imports_nothing_of_the_program():
    p = subprocess.run([sys.executable, "-c", REF_SCRIPT.format(root=ROOT)],
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert "BAD []" in p.stdout


def test_a_result_is_refused_when_jax_loads_after_the_window(monkeypatch, capsys):
    """``main`` looks again once the judge and the readers have run."""
    import types

    import torch

    from benchmark.core import harness

    def run_cell(*a, **k):
        # As a judge or a reader that loaded JAX would leave it.
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
        return {"correct": True}

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(harness, "run_cell", run_cell)
    rc = harness.main(["--workload", "cop20k_A.chain_k32", "--seed", "1",
                       "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0
    assert _json_lines(out.out) == []
    assert "jax" in out.err


def test_end_to_end_names_take_the_loops_value_by_base_name():
    from benchmark.core.harness import _e2e

    got = _e2e(load_cell("cop20k_A.chain_k1"),
               {"gnnz_per_s": 15.0, "setup_s": 20.0})
    assert got == {"gnnz_per_s.k1": {"value": 15.0, "unit": "Gnnz/s"},
                   "setup_s": {"value": 20.0, "unit": "s"}}


def _run_py(cwd):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "cop20k_A.chain_k32",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def _json_lines(text):
    out = []
    for line in text.splitlines():
        try:
            out.append(json.loads(line))
        except json.JSONDecodeError:
            pass
    return out


def test_run_without_a_card_exits_non_zero_with_no_result():
    p = _run_py(ROOT)
    assert p.returncode != 0
    assert _json_lines(p.stdout) == []
    assert "CUDA" in p.stderr


def test_run_without_the_program_exits_non_zero(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run_py(tmp_path)
    assert p.returncode != 0
    assert _json_lines(p.stdout) == []
