"""The ``dc1`` configuration: its frozen stand-in against the program's
``dc1_like`` bit for bit, its counts at full scale, the ``dc1.chain_k32``
cell end to end at a tiny scale on the CPU, and the ``staged_mb`` reader
of the gather route's counter."""

import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.core.cells import BENCH_DIR, load_cell, load_reader
from benchmark.core.harness import run_cell
from benchmark.reference.operators import find_generator

PORT = "sparsematrixmultiplicationmpi_tpu_torch"
port = pytest.importorskip(f"{PORT}.io.generate")
P = pytest.importorskip(f"{PORT}.utils.profiling")

CELL = "dc1.chain_k32"
SEED = 2**31 + 13
CONFIG = json.load(open(os.path.join(BENCH_DIR, "configs", "dc1.json")))
#: Entries of the four rail rows (and columns) of the stand-in at scale 1,
#: pattern seed 0: each rail's draws, its stamps and its diagonal entry.
RAILS = [40_896, 11_689, 3_508, 1_171]


@pytest.fixture(autouse=True)
def empty_registry():
    P.reset_spans()
    yield
    P.reset_spans()


@pytest.mark.parametrize("scale", [0.01, 0.05])
@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11])
def test_stand_in_matches_the_program(seed, scale):
    a = find_generator("dc1_like")(seed, np.float64, scale)
    b = port.dc1_like(seed=seed, dtype=np.float64, scale=scale)
    assert a.shape == b.shape
    np.testing.assert_array_equal(a.row_ptr, np.asarray(b.row_ptr))
    np.testing.assert_array_equal(a.col_indices, np.asarray(b.col_indices))
    np.testing.assert_array_equal(a.values, np.asarray(b.values))
    assert a.col_indices.dtype == np.int32 and a.row_ptr.dtype == np.int32


def test_stand_in_has_the_configurations_counts_and_rails():
    a = find_generator(CONFIG["generator"])(
        CONFIG["pattern_seed"], np.float64, CONFIG["scale"])
    assert a.shape == (CONFIG["rows"], CONFIG["cols"])
    assert a.nnz == CONFIG["nnz"]
    assert CONFIG["published"]["nnz"] - a.nnz == 7
    rows = np.diff(a.row_ptr)
    cols = np.bincount(a.col_indices, minlength=a.shape[1])
    assert sorted(rows)[::-1][:4] == RAILS
    assert sorted(cols)[::-1][:4] == RAILS
    # The next row is a device stamp's, orders of magnitude shorter.
    assert sorted(rows)[::-1][4] < 32


def _tiny(**fmt):
    cell = load_cell(CELL)
    cell.config["scale"] = 0.02
    cell.traffic["sample_range"] = [cell.traffic["sample_range"][0], 40]
    cell.traffic["format"] = dict(cell.traffic["format"], **fmt)
    return cell


def _run(cell, wrap=None, trace=False):
    """One run of 1 s on one CPU thread: the comparison needs bodies past
    the start steps, and with the test workers' threads oversubscribing
    the CPUs one multi-threaded body stalled for over a second."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return run_cell(cell, SEED, 1.0, trace, "cpu", wrap=wrap,
                        log=lambda *a: None)
    finally:
        torch.set_num_threads(threads)


def _unchanged(inputs, device):
    """``test_benchmark_loops.py``'s fault: a body that returns its input."""
    return lambda enc, body, dec: (enc, lambda x, op: x, dec)


def test_the_cell_reads_its_metrics_and_is_correct():
    cell = load_cell(CELL)
    assert cell.config["name"] == "dc1" and cell.traffic["k"] == 32
    assert {m["name"] for m in cell.end_to_end} == {"gnnz_per_s", "setup_s"}
    layer = {m["name"] for m in cell.per_layer}
    assert {"spmm_roofline.dc1", "device_idle_pct.dc1", "issue_ms.dc1",
            "staged_mb.dc1", "format_build_s"} <= layer
    res = _run(_tiny())
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert res["metrics"]["gnnz_per_s"]["value"] > 0


def test_a_body_that_returns_its_input_is_not_correct():
    res = _run(_tiny(), wrap=_unchanged)
    assert not res["correct"], res["checks"]
    assert res["failed"] > 0


def test_the_traced_gather_route_reads_its_staged_bytes():
    """With the card's cost table the stand-in takes the COO route on the
    CPU too: the traced window counts two (nnz x 32) float32 arrays a
    multiply."""
    from sparsematrixmultiplicationmpi_tpu_torch.formats.cost import H100

    cell = _tiny(cost_table=H100)
    res = _run(cell, trace=True)
    assert res["correct"], res["checks"]
    nnz = find_generator("dc1_like")(0, np.float64, 0.02).nnz
    got = res["metrics"]["staged_mb.dc1"]
    assert got["unit"] == "MB"
    assert got["value"] == pytest.approx(2 * nnz * 32 * 4 / 1e6, rel=1e-12)
    snap = P.snapshot()
    assert snap["coo.staged_bytes"]["count"] == snap["coo.gather"]["count"]
    assert snap["coo.gather"]["count"] == snap["coo.scatter"]["count"]


def test_staged_mb_reads_none_without_the_counter(monkeypatch):
    read = load_reader("staged_mb.dc1")
    assert read(None) is None
    with profile(activities=[ProfilerActivity.CPU]):
        with P.span("coo.gather"):
            pass
        P.count("another.staged_bytes", 10)
    assert read(None) is None
    with profile(activities=[ProfilerActivity.CPU]):
        P.count("coo.staged_bytes", 3_000_000)
        P.count("coo.staged_bytes", 5_000_000)
    assert read(None) == pytest.approx(4.0)
    # A program with no registry (a commit before it had one).
    monkeypatch.delattr(P, "snapshot")
    assert read(None) is None
