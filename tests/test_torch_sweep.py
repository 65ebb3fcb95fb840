"""The port's sweep runner (``bench/harness.py::sweep``) on the CPU: the
JAX package's ``test_sweep_resume.py`` cases (a failed row, a failed
construction, ``on_error="raise"``, checkpoint and resume, the CLI's
``--resume``, the watchdog, a sibling sweep's failures kept, canonical
names, the ``backend_ok`` gate, the early abort) on the port, the CSV
schema letter for letter the JAX package's and its CSVs read across
packages, a job on two spawned gloo ranks, and a job on more ranks than
cards recorded as a failed row; the timing helpers the harness exports
beside it (``PhaseTimer``, ``time_fn_amortized``).
"""

import csv
import dataclasses
import math
import time

import pytest
import torch

from sparsematrixmultiplicationmpi_tpu.bench import harness as JH
from sparsematrixmultiplicationmpi_tpu_torch.bench.harness import (
    CSV_COLUMNS, BenchRecord, read_csv, sweep, write_csv, write_json,
)
from sparsematrixmultiplicationmpi_tpu_torch.cli import main as cli_main
from sparsematrixmultiplicationmpi_tpu_torch.io.generate import random_csr
from sparsematrixmultiplicationmpi_tpu_torch.parallel.strategies import (
    STRATEGIES, RowWise, Strategy,
)

CPU = dict(device="cpu", warmup=1, iters=1)


class _Exploding(Strategy):
    name = "exploding"

    def prepare(self, csr, mesh):
        return None

    def spmm(self, operand, v, mesh=None, *, gather_result=True):
        raise RuntimeError("boom")


class _BadCtor(Strategy):
    name = "bad_ctor"

    def __init__(self):
        raise ValueError("ctor boom")

    def prepare(self, csr, mesh):  # pragma: no cover — never reached
        return None

    def spmm(self, operand, v, mesh=None, *, gather_result=True):
        raise NotImplementedError  # pragma: no cover


class _ExplodingAliased(_Exploding):
    name = "exploding_canonical"


class _Hung(RowWise):
    name = "hung"

    def prepare(self, csr, mesh):
        time.sleep(60)
        return super().prepare(csr, mesh)


@pytest.fixture
def registered():
    """Register test strategies in the port's registry for one test."""
    added = []

    def add(name, cls):
        STRATEGIES[name] = cls
        added.append(name)

    yield add
    for name in added:
        del STRATEGIES[name]


def _rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def test_failed_job_recorded_not_fatal(registered):
    registered("exploding", _Exploding)
    mats = {"m": random_csr(30, 30, 150, seed=171)}
    records = sweep(mats, ks=[2], strategy_names=["row", "exploding"],
                    device_counts=[1], **CPU)
    assert len(records) == 2
    ok = {r.strategy: r for r in records}
    assert ok["row_wise"].correct is True and ok["row_wise"].error is None
    assert ok["exploding"].correct is False
    assert ok["exploding"].gflops == 0.0
    assert "RuntimeError" in ok["exploding"].error
    assert "boom" in ok["exploding"].error
    assert ok["exploding"].device_kind == "cpu"


def test_strategy_construction_failure_recorded(tmp_path, registered):
    registered("bad_ctor", _BadCtor)
    path = str(tmp_path / "ckpt.csv")
    mats = {"m": random_csr(30, 30, 150, seed=174)}
    records = sweep(mats, ks=[2], strategy_names=["bad_ctor", "row"],
                    device_counts=[1], checkpoint_csv=path, **CPU)
    assert [r.strategy for r in records] == ["bad_ctor", "row_wise"]
    assert records[0].correct is False
    assert "ctor boom" in records[0].error
    rows = _rows(path)
    assert len(rows) == 2 and "ctor boom" in rows[0]["error"]


def test_on_error_raise(registered):
    registered("exploding", _Exploding)
    mats = {"m": random_csr(30, 30, 150, seed=172)}
    with pytest.raises(RuntimeError):
        sweep(mats, ks=[2], strategy_names=["exploding"], device_counts=[1],
              on_error="raise", **CPU)


def test_checkpoint_and_resume(tmp_path):
    path = str(tmp_path / "ckpt.csv")
    mats = {"m": random_csr(30, 30, 150, seed=173)}
    first = sweep(mats, ks=[2], strategy_names=["row"], device_counts=[1],
                  checkpoint_csv=path, **CPU)
    assert len(first) == 1 and len(_rows(path)) == 1
    # A widened sweep: the finished job is skipped, the new one appends.
    second = sweep(mats, ks=[2], strategy_names=["row", "nnz"],
                   device_counts=[1], resume_from=path, checkpoint_csv=path,
                   **CPU)
    assert [r.strategy for r in second] == ["nnz"]
    assert {r["strategy"] for r in _rows(path)} == {"row_wise", "nnz"}


def test_cli_sweep_resume(tmp_path, capsys):
    csv_path = str(tmp_path / "s.csv")
    args = ["sweep", "synthetic:cage4", "--k", "1", "--devices", "1",
            "--device", "cpu", "--iters", "1", "--csv", csv_path]
    assert cli_main(args + ["--strategy", "row"]) == 0
    with open(csv_path) as f:
        n_before = len(f.readlines())
    # Resume with an extra strategy: only the new job runs and appends.
    assert cli_main(args + ["--strategy", "row", "nnz", "--resume"]) == 0
    out = capsys.readouterr().out
    assert "nnz" in out
    with open(csv_path) as f:
        assert len(f.readlines()) == n_before + 1
    # Resumed again, no job runs.
    assert cli_main(args + ["--strategy", "row", "nnz", "--resume"]) == 0
    assert " k=1 " not in capsys.readouterr().out
    assert len(read_csv(csv_path)) == 2


def test_sweep_watchdog_kills_hung_job(registered):
    registered("hung", _Hung)
    mats = {"a": random_csr(30, 30, 120, seed=7)}
    t0 = time.time()
    records = sweep(mats, ks=[1], strategy_names=["hung", "row"],
                    device_counts=[1], job_timeout=2.0, **CPU)
    assert time.time() - t0 < 30
    assert [r.strategy for r in records] == ["hung", "row_wise"]
    hung, ok = records
    assert hung.correct is False and "TimeoutError" in hung.error
    assert math.isnan(hung.execution_time)
    assert ok.correct is True


def test_sibling_sweep_keeps_other_tiers_failures(tmp_path, registered):
    registered("exploding", _Exploding)
    path = str(tmp_path / "ckpt.csv")
    mats = {"m": random_csr(30, 30, 150, seed=175)}
    sweep(mats, ks=[2], strategy_names=["exploding"], device_counts=[1],
          checkpoint_csv=path, **CPU)
    mats2 = {"m2": random_csr(30, 30, 150, seed=176)}
    sweep(mats2, ks=[2], strategy_names=["row"], device_counts=[1],
          resume_from=path, checkpoint_csv=path, **CPU)
    by_mat = {r["matrix"]: r for r in _rows(path)}
    assert "boom" in by_mat["m"]["error"]  # the failure survived
    assert by_mat["m2"]["strategy"] == "row_wise"
    # A sweep that covers the failed job drops the stale row and records
    # the retry once.
    sweep(mats, ks=[2], strategy_names=["exploding"], device_counts=[1],
          resume_from=path, checkpoint_csv=path, **CPU)
    m_rows = [r for r in _rows(path) if r["matrix"] == "m"]
    assert len(m_rows) == 1 and "boom" in m_rows[0]["error"]


def test_failed_row_uses_canonical_strategy_name(registered):
    registered("expl_alias", _ExplodingAliased)
    mats = {"m": random_csr(30, 30, 150, seed=177)}
    records = sweep(mats, ks=[2], strategy_names=["expl_alias"],
                    device_counts=[1], **CPU)
    assert records[0].strategy == "exploding_canonical"
    assert "boom" in records[0].error


def test_backend_ok_gates_the_dead_backend_guard(registered):
    registered("exploding", _Exploding)
    mats = {"m": random_csr(30, 30, 150, seed=178)}
    records = sweep(mats, ks=[1, 2, 3], strategy_names=["exploding"],
                    device_counts=[1], max_consecutive_failures=2,
                    backend_ok=lambda: True, **CPU)
    assert len(records) == 3 and all(r.error for r in records)
    with pytest.raises(RuntimeError, match="consecutive"):
        sweep(mats, ks=[1, 2, 3], strategy_names=["exploding"],
              device_counts=[1], max_consecutive_failures=2,
              backend_ok=lambda: False, **CPU)


def test_max_consecutive_failures_aborts_early(tmp_path, registered):
    registered("exploding", _Exploding)
    mats = {"m": random_csr(30, 30, 150, seed=171)}
    ckpt = str(tmp_path / "ck.csv")
    with pytest.raises(RuntimeError, match="consecutive"):
        sweep(mats, ks=[1, 2, 3], strategy_names=["exploding"],
              device_counts=[1], checkpoint_csv=ckpt,
              max_consecutive_failures=2, **CPU)
    rows = _rows(ckpt)
    assert len(rows) == 2 and all(r["error"] for r in rows)
    # Alternating success and failure never reaches the threshold.
    records = sweep(mats, ks=[1, 2, 3], strategy_names=["row", "exploding"],
                    device_counts=[1], max_consecutive_failures=2, **CPU)
    assert len(records) == 6


def test_csv_columns_are_the_jax_packages():
    assert CSV_COLUMNS == JH.CSV_COLUMNS
    assert [f.name for f in dataclasses.fields(BenchRecord)] == \
        [f.name for f in dataclasses.fields(JH.BenchRecord)]


def _record_kwargs(**kw):
    base = dict(
        matrix="m", m=100, n=100, nnz=1000, k=6, strategy="auto",
        devices=1, execution_time=1e-3, prepare_time=0.25, correct=True,
        max_error=1.5e-7, gflops=1.0, gnnz_per_s=1.0,
        roofline_fraction=0.3, dtype="float32", device_kind="cpu",
        gathered=True)
    base.update(kw)
    return base


RECORDS = [
    _record_kwargs(),
    _record_kwargs(k=12, execution_time=float("nan"), correct=None,
                   max_error=None, roofline_fraction=None,
                   time_upper_bound=2e-6, comp_time=1e-4, comm_time=2e-5),
    _record_kwargs(strategy="row_wise", correct=False, gflops=0.0,
                   error="RuntimeError: boom", gathered=False),
    _record_kwargs(k=32, remeasured=3, spread_rel=0.125),
]


def _same(a, b):
    for key in CSV_COLUMNS:
        x, y = getattr(a, key), getattr(b, key)
        if isinstance(x, float) and math.isnan(x):
            assert isinstance(y, float) and math.isnan(y), key
        else:
            assert x == y, key


def test_port_reads_a_jax_written_csv(tmp_path):
    path = str(tmp_path / "jax.csv")
    JH.write_csv(path, [JH.BenchRecord(**kw) for kw in RECORDS])
    back = read_csv(path)
    for got, kw in zip(back, RECORDS):
        _same(got, BenchRecord(**kw))


def test_jax_reads_a_port_written_csv_and_json(tmp_path):
    path = str(tmp_path / "port.csv")
    records = [BenchRecord(**kw) for kw in RECORDS]
    write_csv(path, records)
    for got, want in zip(JH.read_csv(path), records):
        _same(got, want)
    with open(path) as f:
        assert next(csv.reader(f)) == JH.CSV_COLUMNS
    write_json(str(tmp_path / "r.json"), records, note="test")
    import json

    payload = json.loads((tmp_path / "r.json").read_text())
    assert payload["note"] == "test" and len(payload["records"]) == 4


def test_more_ranks_than_cards_is_a_failed_row(monkeypatch):
    """On a machine with one card, a job on four ranks raises inside the
    job (no rank is spawned) and is recorded as failed; so is a card job
    where there is no CUDA."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    mats = {"m": random_csr(30, 30, 150, seed=179)}
    records = sweep(mats, ks=[2], strategy_names=["row"],
                    device_counts=[4], device="cuda", warmup=1, iters=1)
    assert len(records) == 1 and records[0].devices == 4
    assert "4 ranks need 4 CUDA devices, have 1" in records[0].error
    if not torch.cuda.is_available():
        rec = sweep(mats, ks=[2], strategy_names=["row"],
                    device_counts=[1], device="cuda", warmup=1, iters=1)[0]
        assert rec.error and rec.device_kind == "no CUDA device"


def test_sweep_on_two_spawned_ranks():
    """p = 2 runs on two gloo ranks; rank 0's record comes back."""
    mats = {"m": random_csr(40, 40, 200, seed=52)}
    records = sweep(mats, ks=[4], strategy_names=["row"],
                    device_counts=[2], **CPU)
    assert len(records) == 1
    rec = records[0]
    assert rec.error is None and rec.correct is True
    assert rec.devices == 2 and rec.strategy == "row_wise"


def test_phase_timer_accumulates_and_synchronizes():
    """``PhaseTimer`` (the JAX package's phase timer: same records, same
    sums) waits on what ``sync`` names before the clock stops."""
    from sparsematrixmultiplicationmpi_tpu.utils.timing import (
        Timing as JTiming,
    )
    from sparsematrixmultiplicationmpi_tpu_torch import PhaseTimer
    from sparsematrixmultiplicationmpi_tpu_torch.utils.timing import Timing

    timer = PhaseTimer()
    x = torch.ones(4)
    with timer.phase("load", sync=x):
        time.sleep(0.01)
    with timer.phase("spmm") as box:
        box["sync"] = {"out": x * 2, "dev": "cpu"}
    with timer.phase("load", sync=[x, torch.device("cpu")]):
        pass
    assert [r.name for r in timer.records] == ["load", "spmm", "load"]
    sums = timer.as_dict()
    assert set(sums) == {"load", "spmm"} and sums["load"] >= 0.01
    assert timer.total("lo") == sums["load"]
    assert timer.total() == pytest.approx(sum(sums.values()))
    assert Timing("a", 1.5).to_dict() == JTiming("a", 1.5).to_dict()


def test_time_fn_amortized_returns_the_result():
    from sparsematrixmultiplicationmpi_tpu_torch import time_fn_amortized

    v = torch.ones((64, 4))
    a = torch.eye(64) * 3

    seconds, out = time_fn_amortized(lambda vv, m: m @ vv, v, a, inner=4,
                                     iters=2)
    assert torch.equal(out, a @ v)
    assert math.isnan(seconds) or seconds > 0
