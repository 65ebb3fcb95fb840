"""The trace reduction and the metric readers on a recorded synthetic trace."""

import pytest

from benchmark.core.cells import load_cell, load_reader
from benchmark.core.harness import RunContext
from benchmark.core.trace import summarize


def X(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def chain_trace():
    """A 100 us window: two bodies, each launching one kernel of 30 us,
    the two kernels overlapping by 5 us, a copy outside any body."""
    return [
        X("user_annotation", "bench.window", 0, 100),
        X("user_annotation", "bench.body", 1, 4),
        X("cuda_runtime", "cudaLaunchKernel", 2, 1, corr=1),
        X("user_annotation", "bench.body", 6, 4),
        X("cuda_driver", "cuLaunchKernel", 7, 1, corr=2),
        X("cpu_op", "aten::item", 40, 50),
        X("cuda_runtime", "cudaMemcpyAsync", 41, 1, corr=3),
        X("kernel", "tmulti_kernel", 10, 30, corr=1),
        X("kernel", "tmulti_kernel", 35, 30, corr=2),
        X("gpu_memcpy", "Memcpy DtoH", 80, 10, corr=3),
        X("gpu_user_annotation", "bench.body", 10, 50),
        X("kernel", "outside", 150, 10, corr=9),   # after the window
        {"ph": "i", "name": "marker", "ts": 5},
    ]


def test_summary_union_spans_and_gaps():
    s = summarize(chain_trace())
    assert s.window_s == pytest.approx(100e-6)
    assert s.busy_s == pytest.approx(65e-6)       # [10, 65) and [80, 90)
    body = s.spans["bench.body"]
    assert body.count == 2 and body.device_ops == 2
    assert body.host_s == pytest.approx(8e-6)
    assert body.device_s == pytest.approx(60e-6)
    assert s.n_device_ops == 3 and s.n_attributed == 3
    assert s.device_ops[0] == ["tmulti_kernel", pytest.approx(60e-6)]
    gaps = dict(s.idle_gaps)
    assert gaps["loop/aten::item"] == pytest.approx(25e-6)   # [65, 80) and [90, 100)
    assert gaps["loop/python"] == pytest.approx(10e-6)       # [0, 10)
    assert sum(gaps.values()) == pytest.approx(35e-6)


def test_a_trace_without_the_window_span_is_refused():
    with pytest.raises(ValueError):
        summarize([X("kernel", "k", 0, 1)])


def _run(cell, trace, floor_s=15.67e-6, **counters):
    c = load_cell(cell)
    return RunContext(cell=c, setup={"format_build_s": 8.5},
                      counters=counters, trace=trace, floor_s=floor_s,
                      multiply_span=c.loop_module().Loop.MULTIPLY_SPAN)


def test_chain_readers():
    run = _run("cop20k_A.chain_k32", summarize(chain_trace()))
    assert load_reader("issue_ms.chain")(run) == pytest.approx(4e-3)
    assert load_reader("spmm_roofline.chain")(run) == pytest.approx(
        100 * 15.67e-6 * 2 / 60e-6)
    assert load_reader("device_idle_pct.chain")(run) == pytest.approx(35.0)
    assert load_reader("format_build_s")(run) == 8.5


def test_pagerank_readers():
    ev = [
        X("user_annotation", "bench.window", 0, 200),
        X("user_annotation", "bench.solve", 0, 100),
        X("user_annotation", "bench.spmm", 10, 5),
        X("cuda_runtime", "cudaLaunchKernel", 11, 1, corr=1),
        X("cuda_runtime", "cudaLaunchKernel", 20, 1, corr=2),
        X("kernel", "index_add", 12, 8, corr=1),
        X("kernel", "abs_max", 25, 2, corr=2),
    ]
    run = _run("amazon0302.pagerank_k1", summarize(ev), floor_s=3.6e-6,
               iterations=[40, 42])
    assert load_reader("issue_ms.pagerank")(run) == pytest.approx(5e-3)
    assert load_reader("spmm_roofline.pagerank")(run) == pytest.approx(45.0)
    assert load_reader("iterations_per_solve.pagerank")(run) == 41
    assert load_reader("device_idle_pct.pagerank")(run) == pytest.approx(95.0)


def test_readers_find_nothing_without_a_trace():
    run = _run("cop20k_A.chain_k32", None)
    for name in ("issue_ms.chain", "spmm_roofline.chain",
                 "device_idle_pct.chain"):
        assert load_reader(name)(run) is None
    # No card with a published peak: no roofline share, never 0.
    run = _run("cop20k_A.chain_k32", summarize(chain_trace()), floor_s=None)
    assert load_reader("spmm_roofline.chain")(run) is None


def test_issue_time_leaves_out_bodies_that_waited_for_a_launch_slot(
        monkeypatch):
    """Six bodies each launch a 100 us kernel; the device runs them one
    after another. With room for two pending launches, bodies 0-1 issue
    in 10 us and the later ones wait for a slot (100 us): the reader
    takes the first two, where the mean of all six would be paced by the
    kernel."""
    from benchmark.core import trace

    monkeypatch.setattr(trace, "PENDING_FREE", 2)
    ev = [X("user_annotation", "bench.window", 0, 1000)]
    t, dev_free = 1, 0
    for i in range(6):
        host = 10 if i < 2 else 100
        ev.append(X("user_annotation", "bench.body", t, host))
        ev.append(X("cuda_runtime", "cudaLaunchKernel", t + host - 2, 1,
                    corr=i + 1))
        start = max(t + host, dev_free)
        ev.append(X("kernel", "tmulti_kernel", start, 100, corr=i + 1))
        dev_free = start + 100
        t += host + 1
    s = summarize(ev)
    assert len(s.spans["bench.body"].free_host_s) == 2
    run = _run("cop20k_A.chain_k32", s)
    assert load_reader("issue_ms.chain")(run) == pytest.approx(10e-3)


@pytest.mark.parametrize("metric", [
    "issue_ms.chain_k1", "spmm_roofline.chain_k1", "device_idle_pct.chain_k1",
    "iterations_per_solve.pagerank", "device_idle_pct.pagerank"])
def test_a_metric_split_by_cell_reads_its_base_names_file(metric):
    from benchmark.core.cells import reader_path

    base = metric.split(".")[0]
    assert reader_path(metric).endswith(f"/metrics/{base}.py")
