"""Card-only tests of the command line: ``run --strategy all`` on the small
cop20k stand-in gives "Results are the same!" for every strategy, and
its ``auto`` and ``column`` multiplies launch the kernels of the route
``auto`` took there (``ops/auto.py::route_kernels``: bucketed ELL's B7
under the H100 cost table), one multiply's each, and no other kernel; a
``convert`` to the band format and a ``run`` of the file launch B5 once
per multiply; a card sweep resumes without running a job again.

Every test needs an NVIDIA GPU and ``nvcc`` and skips from inside the
``cuda`` fixture elsewhere. The file imports no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda_cli.py
"""

import json

import pytest
import torch

from sparsematrixmultiplicationmpi_tpu_torch.bench.harness import read_csv
from sparsematrixmultiplicationmpi_tpu_torch.cli import main as cli_main
from sparsematrixmultiplicationmpi_tpu_torch.ops import (
    cuda_banded, cuda_gather, cuda_windowed,
)
from sparsematrixmultiplicationmpi_tpu_torch.ops.auto import (
    route_kernels, spmm_any,
)
from sparsematrixmultiplicationmpi_tpu_torch.parallel import strategies

KERNEL_MODULES = (cuda_windowed, cuda_banded, cuda_gather)

pytestmark = pytest.mark.gpu


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _reset_counts():
    for mod in KERNEL_MODULES:
        mod.reset_launch_counts()


def _counts() -> dict:
    return {name: n for mod in KERNEL_MODULES
            for name, n in mod.launch_counts().items()}


def test_run_all_strategies_on_the_card(cuda, tmp_path, capsys,
                                        monkeypatch):
    prepared = []

    class RecordedAuto(strategies.Auto):
        def prepare(self, csr, mesh):
            op = super().prepare(csr, mesh)
            prepared.append(op)
            return op

    monkeypatch.setitem(strategies.STRATEGIES, "auto", RecordedAuto)
    _reset_counts()
    rc = cli_main(["run", "synthetic:cop20k_small", "--k", "32",
                   "--iters", "2", "--warmup", "1",
                   "--json", str(tmp_path / "r.json")])
    counts = _counts()
    out = capsys.readouterr().out
    assert rc == 0, out
    assert out.count("Results are the same!") == 5
    payload = json.loads((tmp_path / "r.json").read_text())
    name = torch.cuda.get_device_name(0)
    assert all(r["correct"] is True and r["device_kind"] == name
               for r in payload["records"])
    # ``auto`` and ``column`` (the same pick on one rank) take the route
    # ``auto`` took: one warm-up and two timed multiplies each.
    assert len(prepared) == 1
    op = prepared[0]
    route = route_kernels(op, 32)
    assert route, f"auto took {type(op).__name__}, a route with no kernel"
    _reset_counts()
    spmm_any(op, torch.zeros((op.shape[1], 32), device=cuda))
    per = _counts()
    assert all(per[k] > 0 for k in route), (route, per)
    assert counts == {k: 6 * n for k, n in per.items()}, (route, counts)


def test_convert_then_prepared_run_launches_b5(cuda, tmp_path, capsys):
    path = str(tmp_path / "band.npz")
    assert cli_main(["convert", "synthetic:banded", path,
                     "--format", "banded"]) == 0
    cuda_banded.reset_launch_counts()
    assert cli_main(["run", path, "--k", "8", "--iters", "3",
                     "--warmup", "1"]) == 0
    out = capsys.readouterr().out
    assert "[BandedBlocks]" in out and "Auto Execution time:" in out
    # time_fn: one warm-up call and three timed calls, one B5 each.
    assert cuda_banded.launch_counts()["B5"] == 4


def test_card_sweep_resumes(cuda, tmp_path, capsys):
    csv_path = str(tmp_path / "s.csv")
    args = ["sweep", "synthetic:cage4", "--k", "8", "--devices", "1",
            "--strategy", "auto", "row", "--iters", "1", "--csv", csv_path]
    assert cli_main(args) == 0
    assert cli_main(args + ["--resume"]) == 0
    out = capsys.readouterr().out
    assert out.count(" k=8 p=1 ") == 2  # two jobs, run once
    rows = read_csv(csv_path)
    assert len(rows) == 2 and all(r.correct for r in rows)
