"""The port's spans and phases (``utils/profiling.py``): what a disabled
span costs (nothing recorded, one shared no-op), what PageRank's loop
records under ``torch.profiler`` on the CPU and that tracing moves no
bit of its result, and the format build's phases in ``Auto.prepare``.

The card-only counterparts (``windowed.pad`` a body at narrow k,
``format.card_planes`` a ``.to("cuda")``) are in
``test_torch_cuda_spans.py``."""

import dataclasses
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sparsematrixmultiplicationmpi_tpu_torch.io.generate import (
    banded_csr, powerlaw_csr, random_csr,
)
from sparsematrixmultiplicationmpi_tpu_torch.models.pagerank import (
    normalize_columns, pagerank,
)
from sparsematrixmultiplicationmpi_tpu_torch.ops.auto import spmm_any
from sparsematrixmultiplicationmpi_tpu_torch.parallel.strategies import Auto
from sparsematrixmultiplicationmpi_tpu_torch.utils import profiling as P

FORMAT_PHASES = ("format.windowed", "format.rivals", "format.place")


@pytest.fixture(autouse=True)
def empty_registry():
    P.reset_spans()
    yield
    P.reset_spans()


def _graph(n=300, nnz=2400, seed=3):
    csr = random_csr(n, n, nnz, seed=seed)
    return normalize_columns(
        dataclasses.replace(csr, values=np.abs(csr.values)))


def _solve(csr, max_iter=200):
    op = Auto().prepare(csr, "cpu")
    return pagerank(lambda v: spmm_any(op, v), csr.shape[0], damping=0.85,
                    tol=1e-9, max_iter=max_iter, dtype=torch.float64,
                    device="cpu")


def test_a_disabled_span_records_nothing_and_is_the_shared_noop():
    assert not P._recording()
    a, b = P.span("pagerank.update"), P.span("windowed.pad")
    assert a is b is P._NOOP
    with a:
        with b:
            pass
    assert P.snapshot() == {}


def test_a_span_records_only_while_a_profiler_records():
    with profile(activities=[ProfilerActivity.CPU]):
        assert P._recording()
        s = P.span("x")
        assert s is not P._NOOP
        with s:
            torch.ones(4).sum()
    assert not P._recording()
    assert P.span("x") is P._NOOP
    got = P.snapshot()["x"]
    assert got["count"] == 1 and len(got["durations_s"]) == 1
    assert got["total_s"] == pytest.approx(got["durations_s"][0])
    assert got["durations_s"][0] > 0


def test_pagerank_spans_under_the_profiler(tmp_path):
    csr = _graph()
    _solve(csr)  # warm, and its phases go before the traced solve
    P.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        r, iterations = _solve(csr)
    assert 1 < iterations < 200
    snap = P.snapshot()
    assert snap["pagerank.update"]["count"] == iterations
    # The last test ends the loop, so the read is one more than updates.
    assert snap["pagerank.converged"]["count"] == iterations + 1
    for name in ("pagerank.update", "pagerank.converged"):
        assert len(snap[name]["durations_s"]) == snap[name]["count"]
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())
    if isinstance(events, dict):
        events = events["traceEvents"]
    names = [e["name"] for e in events
             if e.get("cat") == "user_annotation" and e.get("ph") == "X"]
    assert names.count("pagerank.update") == iterations
    assert names.count("pagerank.converged") == iterations + 1


@pytest.mark.parametrize("max_iter", [200, 5])
def test_traced_pagerank_is_bit_identical_to_untraced(max_iter):
    csr = _graph(seed=5)
    r0, it0 = _solve(csr, max_iter)
    with profile(activities=[ProfilerActivity.CPU]):
        r1, it1 = _solve(csr, max_iter)
    assert it0 == it1
    assert torch.equal(r0, r1)
    # Stopped by max_iter, the loop makes no last read.
    if max_iter == 5:
        assert it1 == 5
        assert P.snapshot()["pagerank.converged"]["count"] == 5


@pytest.mark.parametrize("make", [
    lambda: banded_csr(600, 12, 6, seed=2).astype(np.float32),
    lambda: powerlaw_csr(400, 400, 3000, seed=4).astype(np.float32),
], ids=["banded", "powerlaw"])
def test_auto_prepare_records_each_format_phase_once(make):
    csr = make()
    Auto().prepare(csr, "cpu")
    snap = P.snapshot()
    for name in FORMAT_PHASES:
        assert snap[name]["count"] == 1, name
        assert snap[name]["total_s"] > 0
        assert snap[name]["durations_s"] == []
    # A CPU copy keeps the host planes: no card planes are built.
    assert "format.card_planes" not in snap
    assert not any(n.startswith(("pagerank.", "windowed.")) for n in snap)


def test_a_phase_records_when_its_body_raises_and_syncs_a_cpu_device():
    with pytest.raises(ValueError):
        with P.phase("p", sync=torch.device("cpu")):
            raise ValueError("boom")
    with P.phase("p", sync=[torch.zeros(1), "cpu"]):
        pass
    assert P.snapshot()["p"]["count"] == 2


def test_a_phase_is_a_region_of_the_trace_while_a_profiler_records(
        tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with P.phase("format.place"):
            torch.ones(8).sum()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())
    if isinstance(events, dict):
        events = events["traceEvents"]
    assert any(e.get("cat") == "user_annotation"
               and e.get("name") == "format.place" for e in events)
    assert P.snapshot()["format.place"]["count"] == 1


def test_snapshot_is_a_copy_and_reset_clears():
    with P.phase("a"):
        pass
    snap = P.snapshot()
    snap["a"]["count"] = 99
    snap["a"]["durations_s"].append(1.0)
    assert P.snapshot()["a"]["count"] == 1
    assert P.snapshot()["a"]["durations_s"] == []
    P.reset_spans()
    assert P.snapshot() == {}

