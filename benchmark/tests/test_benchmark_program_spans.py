"""The readers of the port's own spans and phases
(``utils/profiling.py::snapshot``): a number where the program recorded
the span or phase, None where it did not or where the program has no
registry (a commit before it had one), and the traced run of each cell
at a tiny scale on the CPU."""

import pytest
from torch.profiler import ProfilerActivity, profile

from benchmark.core.cells import load_cell, load_reader
from benchmark.core.harness import run_cell
from sparsematrixmultiplicationmpi_tpu_torch.utils import profiling as P

SEED = 2**31 + 7

#: metric -> (the port's name, whether it is a span (else a phase))
READERS = {
    "sync_ms.pagerank": ("pagerank.converged", True),
    "update_ms.pagerank": ("pagerank.update", True),
    "pad_ms.chain_k1": ("windowed.pad", True),
    "format_windowed_s": ("format.windowed", False),
    "format_rivals_s": ("format.rivals", False),
    "format_place_s": ("format.place", False),
    "format_card_planes_s": ("format.card_planes", False),
}
FORMATS = ("format_windowed_s", "format_rivals_s", "format_place_s")


@pytest.fixture(autouse=True)
def empty_registry():
    P.reset_spans()
    yield
    P.reset_spans()


def _record(name, is_span, times=3):
    if is_span:
        with profile(activities=[ProfilerActivity.CPU]):
            for _ in range(times):
                with P.span(name):
                    pass
    else:
        for _ in range(times):
            with P.phase(name):
                pass


@pytest.mark.parametrize("metric", READERS)
def test_a_reader_reads_its_span_or_phase_and_none_without(metric):
    read = load_reader(metric)
    name, is_span = READERS[metric]
    assert read(None) is None
    _record("another." + name, is_span)
    assert read(None) is None
    _record(name, is_span)
    got = read(None)
    assert isinstance(got, float) and got > 0
    entry = P.snapshot()[name]
    if is_span:
        assert entry["count"] == 3
        assert got == pytest.approx(sorted(entry["durations_s"])[1] * 1e3)
    else:
        assert got == entry["total_s"]


@pytest.mark.parametrize("metric", READERS)
def test_a_reader_gives_none_for_a_program_without_a_registry(
        metric, monkeypatch):
    name, is_span = READERS[metric]
    _record(name, is_span)
    monkeypatch.delattr(P, "snapshot")
    assert load_reader(metric)(None) is None


def _traced(name):
    cell = load_cell(name)
    cell.config["scale"] = 0.01
    cell.traffic["sample_range"] = [cell.traffic["sample_range"][0], 40]
    return run_cell(cell, SEED, 0.3, True, "cpu", log=lambda *a: None)


def test_a_traced_pagerank_run_reports_its_spans():
    res = _traced("amazon0302.pagerank_k1")
    assert res["correct"]
    m = res["metrics"]
    for metric in ("sync_ms.pagerank", "update_ms.pagerank") + FORMATS:
        assert m[metric]["value"] > 0, metric
    assert m["sync_ms.pagerank"]["unit"] == "ms"
    # No windowed operand is moved to a card on the CPU.
    assert "format_card_planes_s" not in m
    # Spans record in the traced window only: each of its solves reads
    # once more than it updates, since its last read ends it.
    snap = P.snapshot()
    assert (snap["pagerank.converged"]["count"]
            == snap["pagerank.update"]["count"] + res["attempted"])


@pytest.mark.parametrize("name", ["cop20k_A.chain_k32", "cop20k_A.chain_k1"])
def test_a_traced_chain_run_reports_the_format_phases(name):
    res = _traced(name)
    assert res["correct"]
    m = res["metrics"]
    parts = sum(m[metric]["value"] for metric in FORMATS)
    assert 0 < parts <= m["format_build_s"]["value"]
    # The CPU's chain takes the plain path: no pad, no card planes.
    assert "pad_ms.chain_k1" not in m
    assert "format_card_planes_s" not in m
