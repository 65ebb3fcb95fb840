"""The port's results, models and scaling scripts
(``sparsematrixmultiplicationmpi_tpu_torch/scripts/``) and its examples
on the CPU, at small sizes: the models benchmark's JSON keys against the
JAX package's ``results/models_tpu.json``; the results sweep stopped part
way and resumed, its CSV read by the JAX package's ``read_csv``, and
rendered; the scaling sweep on two gloo ranks, each strategy's counted
collectives as ``tests/test_torch_collectives.py`` expects them; the
weak-scaling arithmetic against the JAX script's own functions; the
launcher as a one-process gloo cluster; the examples. A card run
without CUDA exits 1. Also: ``run_benchmark`` on ranks whose clocks
disagree still times the same chains on every rank.
"""

import csv
import importlib.util
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from sparsematrixmultiplicationmpi_tpu.bench.harness import (
    read_csv as jax_read_csv,
)
from sparsematrixmultiplicationmpi_tpu_torch.bench.harness import read_csv
from sparsematrixmultiplicationmpi_tpu_torch.parallel import run_ranks
from sparsematrixmultiplicationmpi_tpu_torch.scripts import (
    launch_multihost, project_weak_scaling as pws, render_results,
    run_models_bench, run_results_sweep, run_scaling_sweep,
)

import _torch_dist_ranks as R

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
spec = importlib.util.spec_from_file_location(
    "jax_project_weak_scaling",
    os.path.join(REPO, "scripts", "project_weak_scaling.py"))
jax_pws = importlib.util.module_from_spec(spec)
spec.loader.exec_module(jax_pws)


def _keys(d):
    return {k: sorted(v) if isinstance(v, dict) else None
            for k, v in d.items()}


def test_models_bench_keys_match_the_jax_results(tmp_path, capsys):
    rc = run_models_bench.main([
        "--device", "cpu", "--out-dir", str(tmp_path), "--scale", "0.02"])
    out = capsys.readouterr().out
    assert rc == 0, out
    got = json.load(open(tmp_path / "models_cpu.json"))
    want = json.load(open(os.path.join(REPO, "results", "models_tpu.json")))
    assert _keys(got) == _keys(want)
    assert got["hardware"] == "cpu"
    checks = json.loads(out.strip().splitlines()[-1])["checks"]
    assert checks["pagerank_matches_f64"] and checks["cg_converged"]
    assert abs(got["pagerank_121k"]["rank_sum"] - 1.0) < 1e-4
    assert got["gcn_train_100k_nodes"]["loss_finite"]


def test_pagerank_host_reference_is_a_power_iteration():
    """The f64 reference the models benchmark checks against: a
    stochastic fixed point, its sum 1."""
    from sparsematrixmultiplicationmpi_tpu_torch.io.generate import (
        cop20k_like,
    )
    from sparsematrixmultiplicationmpi_tpu_torch.models import (
        normalize_columns, pagerank,
    )
    from sparsematrixmultiplicationmpi_tpu_torch.ops.oracle import (
        spmm_host_f64,
    )

    g = cop20k_like(scale=0.01, seed=4)
    g = type(g)(values=np.abs(g.values), col_indices=g.col_indices,
                row_ptr=g.row_ptr, shape=g.shape)
    norm = normalize_columns(g)
    ref = run_models_bench.pagerank_host_f64(norm, 40)
    r, it = pagerank(lambda v: torch.from_numpy(spmm_host_f64(norm, v)),
                     norm.shape[0], tol=0.0, max_iter=40, device="cpu")
    assert it == 40 and abs(ref.sum() - 1.0) < 1e-12
    np.testing.assert_allclose(r.numpy(), ref, rtol=1e-12)


def test_pagerank_limit_fails_the_hi_only_matrix():
    """``PAGERANK_RTOL`` passes the port's f32 PageRank through the
    windowed route and fails the same iteration on the matrix rounded to
    bf16, which a split product without its ``lo`` plane multiplies by."""
    from sparsematrixmultiplicationmpi_tpu_torch.io.generate import (
        cop20k_like,
    )
    from sparsematrixmultiplicationmpi_tpu_torch.models import (
        normalize_columns, pagerank,
    )
    from sparsematrixmultiplicationmpi_tpu_torch.ops.auto import (
        auto_format, spmm_any,
    )

    g = cop20k_like(scale=0.05, seed=4)
    g = type(g)(values=np.abs(g.values), col_indices=g.col_indices,
                row_ptr=g.row_ptr, shape=g.shape)
    norm = normalize_columns(g).astype(np.float32)
    op = auto_format(norm, k_nominal=1).to("cpu")
    r, it = pagerank(lambda v: spmm_any(op, v), norm.shape[0], tol=0.0,
                     max_iter=10, dtype=torch.float32, device="cpu")
    ref = run_models_bench.pagerank_host_f64(norm, it)
    ctl = run_models_bench.pagerank_host_f64(
        run_models_bench.hi_only(norm), it)
    assert type(op).__name__ == "WindowedPairs"
    assert np.max(np.abs(r.double().numpy() - ref) / ref) \
        <= run_models_bench.PAGERANK_RTOL
    assert np.max(np.abs(ctl - ref) / ref) > run_models_bench.PAGERANK_RTOL


SWEEP = ["--device", "cpu", "--matrices", "cage4_like", "fem_banded_100k",
         "--ks", "1", "6", "--strategies", "auto", "row", "--scale", "0.01"]


@pytest.fixture(scope="module")
def swept(tmp_path_factory):
    """The sweep run to its end, then its checkpoint cut after three rows
    (a run stopped there) and the sweep run again."""
    out = tmp_path_factory.mktemp("sweep")
    assert run_results_sweep.main(SWEEP + ["--out-dir", str(out)]) == 0
    ckpt = out / "cpu_sweep.csv"
    rows = list(csv.DictReader(open(ckpt)))
    with open(ckpt, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=rows[0].keys())
        w.writeheader()
        w.writerows(rows[:3])
    return out, rows


def test_results_sweep_resumes_where_it_stopped(swept, capfd):
    out, rows = swept
    assert len(rows) == 2 * 2 * 2
    assert run_results_sweep.main(SWEEP + ["--out-dir", str(out)]) == 0
    said = capfd.readouterr().out
    assert f"{len(rows)} records ({len(rows) - 3} new)" in said
    recs = read_csv(out / "cpu_sweep.csv")
    keys = [(r.matrix, r.k, r.strategy) for r in recs]
    assert len(keys) == len(set(keys)) == len(rows)
    assert all(r.correct and not r.error for r in recs)
    assert {r.strategy for r in recs} == {"auto", "row_wise"}
    assert json.load(open(out / "cpu_sweep.json"))["hardware"] == "cpu"
    assert "matrix x k x strategy sweep" in open(out / "REPORT.md").read()


def test_results_sweep_csv_reads_in_the_jax_package(swept):
    out, _ = swept
    ours = read_csv(out / "cpu_sweep.csv")
    theirs = jax_read_csv(str(out / "cpu_sweep.csv"))
    # repr: an unresolved slope is NaN, which equals nothing
    assert [(r.matrix, r.k, r.strategy, repr(r.execution_time), r.correct)
            for r in theirs] == [
        (r.matrix, r.k, r.strategy, repr(r.execution_time), r.correct)
        for r in ours]


@pytest.mark.parametrize("which", ["port", "jax"])
def test_render_results_from_either_packages_csv(swept, tmp_path, which,
                                                 capsys):
    if which == "port":
        src = swept[0] / "cpu_sweep.csv"
    else:
        src = os.path.join(REPO, "results", "tpu_v5e_sweep.csv")
    assert render_results.main([str(src), "--out-dir", str(tmp_path)]) == 0
    said = capsys.readouterr().out
    n = len(read_csv(src))
    assert said.startswith(f"{n} records -> ")
    text = open(tmp_path / "REPORT.md").read()
    assert "**Correctness:**" in text
    if which == "port":
        assert "cpu results" in text


def test_render_results_refuses_a_missing_csv(tmp_path):
    assert render_results.main([str(tmp_path / "none.csv")]) == 1


@pytest.fixture(scope="module")
def scaled(tmp_path_factory):
    out = tmp_path_factory.mktemp("scaling")
    rc = run_scaling_sweep.main([
        "--device", "cpu", "--ps", "2", "--ks", "6", "--scale", "0.01",
        "--out-dir", str(out)])
    return rc, out


def _collectives(out):
    recs = json.load(open(out / "collective_bytes.json"))["records"]
    assert not [r for r in recs if "error" in r]
    return {(r["matrix"], r["strategy"], r["gathered"]): r["collectives"]
            for r in recs}


def test_scaling_sweep_runs_every_strategy_correct(scaled):
    rc, out = scaled
    assert rc == 0
    got = json.load(open(out / "cpu_mesh_scaling.json"))
    want = json.load(open(os.path.join(REPO, "results",
                                       "cpu_mesh_scaling.json")))
    assert set(got) == set(want)
    assert set(got["records"][0]) >= set(want["records"][0])
    recs = read_csv(out / "cpu_mesh_scaling.csv")
    assert len(recs) == 3 * len(run_scaling_sweep.STRATEGIES)
    assert all(r.correct and r.devices == 2 for r in recs)


def test_scaling_sweep_counts_collectives_as_the_collective_tests(scaled):
    """Each strategy's collectives at p = 2, as
    ``tests/test_torch_collectives.py`` asserts them."""
    _, out = scaled
    c = _collectives(out)
    for mat in ("fem3d_50k", "banded_60k", "powerlaw_60k"):
        # the gathered row result: one all-gather of the fat vector rows
        assert c[(mat, "row_wise", True)]["all-gather"]["count"] == 1
        # psum: an all-reduce only
        assert set(c[(mat, "nnz", False)]) == {"all-reduce"}
        # the column split gathers its k-columns, once
        assert set(c[(mat, "column_wise", True)]) == {"all-gather"}
        assert c[(mat, "column_wise", True)]["all-gather"]["count"] == 1
        # an ungathered result moves fewer bytes than a gathered one
        for s in ("row_wise", "column_wise", "windowed_row_wise"):
            total = {g: sum(x["bytes"] for x in c[(mat, s, g)].values())
                     for g in (False, True)}
            assert total[False] < total[True], (mat, s)
    # the band strategy permutes only; the halo mode gathers nothing
    band = c[("banded_60k", "banded_row_wise", False)]
    assert set(band) == {"collective-permute"}
    assert 1 <= band["collective-permute"]["count"] <= 2
    assert "all-gather" not in c[("banded_60k", "windowed_row_wise", False)]


def test_weak_scaling_arithmetic_matches_the_jax_script():
    colls = [{"all-gather": {"count": 1, "bytes": 3_878_912}},
             {"collective-permute": {"count": 2, "bytes": 65_536},
              "reduce-scatter": {"count": 1, "bytes": 1 << 20}},
             {"all-reduce": {"count": 3, "bytes": 10}, "other": {
                 "count": 1, "bytes": 7}}, {}]
    for coll in colls:
        for p in (2, 3, 4, 8, 16, 64):
            for _, bw, lat in pws.NETWORKS:
                assert pws.t_comm(coll, p, bw, lat) == jax_pws.t_comm(
                    coll, p, bw, lat)
                t_c = 2_624_330 / 21.4e9
                assert pws.efficiency(2_624_330, 21.4e9, coll, p, bw,
                                      lat) == t_c / (t_c + jax_pws.t_comm(
                                          coll, p, bw, lat))
    for kind in list(jax_pws.HOPS) + ["other"]:
        for p in (2, 4, 8, 16, 1024):
            assert pws._hops(kind, p) == jax_pws._hops(kind, p)


def test_weak_scaling_projection_from_the_counted_bytes(scaled, tmp_path,
                                                        capsys):
    _, out = scaled
    rate = tmp_path / "sweep.json"
    rate.write_text(json.dumps({"records": [
        {"matrix": "cop20k_like", "k": 32, "strategy": "auto",
         "devices": 1, "error": None, "gnnz_per_s": 20.0,
         "device_kind": "card under test"}]}))
    assert pws.main(["--out-dir", str(tmp_path), "--rate-from", str(rate),
                     "--bytes-from", str(out / "collective_bytes.json")]) \
        == 0
    text = open(tmp_path / "WEAK_SCALING.md").read()
    assert text.count("projected") >= 3 and "PROJECTION" in text
    recs = json.load(open(out / "collective_bytes.json"))["records"]
    row = next(r for r in recs if r["strategy"] == "row_wise"
               and r["gathered"] and r["matrix"] == "fem3d_50k")
    t_c = row["nnz"] / 20e9
    effs = [t_c / (t_c + jax_pws.t_comm(row["collectives"], p,
                                        pws.NVLINK_BW, pws.NVLINK_LAT))
            for p in pws.PS]
    assert ("| fem3d_50k | row_wise | "
            + " | ".join(f"{e * 100:.1f}%" for e in effs) + " |") in text
    cpu = tmp_path / "cpu.json"
    cpu.write_text(rate.read_text().replace("card under test", "cpu"))
    assert pws.main(["--out-dir", str(tmp_path), "--rate-from", str(cpu),
                     "--bytes-from", str(out / "collective_bytes.json")]) \
        == 1


@pytest.mark.parametrize("main,argv", [
    (run_models_bench.main, []),
    (run_results_sweep.main, []),
    (run_scaling_sweep.main, []),
    (launch_multihost.main, ["--coordinator", "127.0.0.1:1",
                             "--num-processes", "1", "--", "info"]),
], ids=["models", "results", "scaling", "launcher"])
def test_a_card_run_without_cuda_exits_1(main, argv, monkeypatch, capsys,
                                         tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(argv + ["--out-dir", str(tmp_path)]
                if main is not launch_multihost.main else argv) == 1
    assert "needs a CUDA device" in capsys.readouterr().err
    assert not list(tmp_path.iterdir())


def test_scaling_sweep_refuses_more_ranks_than_cards(monkeypatch, capsys,
                                                    tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert run_scaling_sweep.main(["--ps", "1", "2", "--out-dir",
                                   str(tmp_path)]) == 1
    assert "--ps 2 needs 2 CUDA devices" in capsys.readouterr().err
    assert not list(tmp_path.iterdir())


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run(argv, env=None, timeout=300):
    full = dict(os.environ, PYTHONPATH=REPO, **(env or {}))
    return subprocess.run([sys.executable, *argv], capture_output=True,
                          text=True, timeout=timeout, cwd=REPO, env=full)


@pytest.mark.parametrize("how", ["flags", "torchrun-env"])
def test_launcher_single_process_cluster(how):
    module = "sparsematrixmultiplicationmpi_tpu_torch.scripts.launch_multihost"
    port = _free_port()
    cli = ["--", "run", "synthetic:cage4", "--k", "3", "--strategy", "row"]
    if how == "flags":
        out = _run(["-m", module, "--coordinator", f"127.0.0.1:{port}",
                    "--num-processes", "1", "--process-id", "0",
                    "--device", "cpu", *cli])
    else:
        out = _run(["-m", module, "--device", "cpu", *cli], env=dict(
            RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
            MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port)))
    assert out.returncode == 0, out.stderr[-2000:]
    assert "[launch] process 0/1" in out.stdout, out.stdout
    assert "backend gloo" in out.stdout
    assert "Results are the same!" in out.stdout, out.stdout


@pytest.mark.parametrize("script,args,expect", [
    ("torch_01_spmm_basics.py", [], "Results are the same!"),
    ("torch_02_distributed_strategies.py", ["--ranks", "2"], "library"),
    ("torch_03_gcn_training.py", [], "held-out accuracy"),
], ids=["basics", "strategies", "gcn"])
def test_examples_run_on_the_cpu(script, args, expect):
    out = _run([os.path.join("examples", script), "--device", "cpu", *args])
    assert out.returncode == 0, out.stderr[-2000:]
    assert expect in out.stdout
    assert "MISMATCH" not in out.stdout
    without = _run([os.path.join("examples", script)],
                   env=dict(CUDA_VISIBLE_DEVICES=""))
    assert without.returncode == 1 and "--device cpu" in without.stderr


def test_ranks_agree_on_lengthening_a_chain():
    """One rank's slope resolves at once, the other's on its third chain:
    both time three chains, so their collectives pair up and the run
    ends with a correct record."""
    got = run_ranks(R.disagreeing_clocks, 2, device="cpu", timeout=120)
    assert got == [(3, True), (3, True)]
