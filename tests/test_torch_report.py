"""The port's report layer on the CPU (``bench/report.py``,
``bench/plots.py``, and ``suspicious_records`` / ``remeasure_record`` of
``bench/harness.py``) against the JAX package's: the same records give
the same report text, the same flagged rows and the same figure files;
the re-measure protocol gives the median run and its spread.
"""

import dataclasses
import os

import pytest
import torch

from sparsematrixmultiplicationmpi_tpu.bench import harness as JH
from sparsematrixmultiplicationmpi_tpu.bench.report import (
    render_report as jax_render_report,
)
from sparsematrixmultiplicationmpi_tpu_torch.bench.harness import (
    BenchRecord, read_csv, remeasure_record, suspicious_records, write_csv,
)
from sparsematrixmultiplicationmpi_tpu_torch.bench.report import (
    render_report,
)
from sparsematrixmultiplicationmpi_tpu_torch.io.generate import banded_csr

NAN = float("nan")


def _kw(**kw):
    base = dict(
        matrix="m", m=100, n=100, nnz=1000, k=6, strategy="auto",
        devices=1, execution_time=1e-3, prepare_time=0.0, correct=True,
        max_error=0.0, gflops=1.0, gnnz_per_s=1.0,
        roofline_fraction=0.3, dtype="float32",
        device_kind="NVIDIA H100 80GB HBM3", gathered=True)
    base.update(kw)
    return base


SETS = {
    "monotonic_and_roofline": [
        _kw(k=1, execution_time=1e-3),
        _kw(k=6, execution_time=1.2e-3),
        _kw(k=12, execution_time=0.2e-3, roofline_fraction=1.16),
        _kw(k=16, execution_time=9e-3),
        _kw(k=32, execution_time=2e-3),
    ],
    "failed_and_unresolved": [
        _kw(k=1, execution_time=NAN, roofline_fraction=None,
            time_upper_bound=3e-6, gflops=NAN, gnnz_per_s=NAN),
        _kw(k=6, execution_time=1e-3, error="boom", correct=False,
            roofline_fraction=2.0),
        _kw(k=6, strategy="row_wise", execution_time=NAN, correct=False,
            error="TimeoutError: job exceeded 2.0 s watchdog",
            roofline_fraction=None, gflops=0.0, gnnz_per_s=0.0),
    ],
    "cop20k_two_matrices": [
        _kw(matrix="synthetic:cop20k", m=121192, n=121192, nnz=2624330,
            k=32, strategy=s, execution_time=t, gnnz_per_s=2.62433e-3 / t,
            gflops=2 * 2624330 * 32 / t / 1e9, roofline_fraction=f)
        for s, t, f in (("auto", 3.2e-4, 0.31), ("library", 2.0e-4, 0.5),
                        ("row_wise", 2.9e-3, 0.03))
    ] + [_kw(matrix="synthetic:cage4", m=9, n=9, nnz=49, k=32,
             execution_time=NAN, roofline_fraction=None,
             time_upper_bound=1e-5)],
    "remeasured": [_kw(k=6, remeasured=3, spread_rel=0.2)],
    "all_artifacts": [_kw(k=6, roofline_fraction=1.4),
                      _kw(k=12, roofline_fraction=1.1)],
    "empty": [],
}


@pytest.mark.parametrize("name", sorted(SETS))
def test_report_text_equals_the_jax_packages(tmp_path, name):
    ours = [BenchRecord(**kw) for kw in SETS[name]]
    theirs = [JH.BenchRecord(**kw) for kw in SETS[name]]
    text = render_report(ours, str(tmp_path / "r.md"), title="T")
    assert text == jax_render_report(theirs, title="T")
    assert (tmp_path / "r.md").read_text() == text
    if ours:
        assert "NVIDIA H100 80GB HBM3" in text


@pytest.mark.parametrize("name", sorted(SETS))
def test_suspicious_records_flag_the_same_rows(name):
    ours = suspicious_records([BenchRecord(**kw) for kw in SETS[name]])
    theirs = JH.suspicious_records(
        [JH.BenchRecord(**kw) for kw in SETS[name]])
    assert [(r.k, r.strategy, why) for r, why in ours] == \
        [(r.k, r.strategy, why) for r, why in theirs]


def test_suspicious_reasons():
    flagged = dict((r.k, why) for r, why in suspicious_records(
        [BenchRecord(**kw) for kw in SETS["monotonic_and_roofline"]]))
    assert "roofline" in flagged[12] and "non-monotonic" in flagged[16]
    assert 32 in flagged and 1 not in flagged and 6 not in flagged


def test_report_never_headlines_impossible_rows():
    text = render_report([
        BenchRecord(**_kw(strategy="honest", execution_time=2e-3,
                          gnnz_per_s=0.5, roofline_fraction=0.4)),
        BenchRecord(**_kw(strategy="artifact", execution_time=0.5e-3,
                          gnnz_per_s=2.0, roofline_fraction=1.16))])
    assert "Best: **honest**" in text
    assert "measurement artifact" in text and "116.0%" in text


def test_remeasure_record_median_and_spread(tmp_path):
    csr = banded_csr(512, 10, 5, seed=1).astype(torch.float32)
    rec = BenchRecord(**_kw(matrix="fem", k=4, strategy="sequential",
                            roofline_fraction=1.5, device_kind="cpu"))
    new = remeasure_record(csr, rec, runs=3, mesh="cpu", iters=2, inner=10)
    assert new.remeasured == 3
    assert new.strategy == "sequential" and new.k == 4
    assert new.correct is True and new.device_kind == "cpu"
    if new.execution_time == new.execution_time:  # resolved on this host
        assert new.spread_rel is not None and new.spread_rel >= 0
    p = tmp_path / "r.csv"
    write_csv(str(p), [new])
    back = read_csv(str(p))[0]
    assert back.remeasured == 3
    assert (back.spread_rel is None) == (new.spread_rel is None)


def test_render_all_writes_the_jax_packages_files(tmp_path):
    pytest.importorskip("matplotlib")
    from sparsematrixmultiplicationmpi_tpu.bench.plots import (
        render_all as jax_render_all,
    )
    from sparsematrixmultiplicationmpi_tpu_torch.bench.plots import (
        render_all,
    )

    kws = [_kw(matrix=mat, k=k, strategy=s, devices=p,
               execution_time=1e-3 * k / p, comp_time=8e-4, comm_time=2e-4)
           for mat in ("a", "synthetic:b") for k in (1, 4)
           for s in ("row_wise", "auto") for p in (1, 2)]
    ours = render_all([BenchRecord(**kw) for kw in kws],
                      str(tmp_path / "ours"))
    theirs = jax_render_all([JH.BenchRecord(**kw) for kw in kws],
                            str(tmp_path / "theirs"))
    assert [os.path.basename(p) for p in ours] == \
        [os.path.basename(p) for p in theirs]
    assert all(os.path.getsize(p) > 0 for p in ours)


def test_record_fields_default_as_the_jax_packages():
    ours = BenchRecord(**_kw())
    theirs = JH.BenchRecord(**_kw())
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
