"""Each cell's loop end to end at a tiny scale on the CPU (the program's
plain paths), the comparison on it, the control and the faults.

``run_cell`` drives everything a run does but the look for a card."""

import importlib

import pytest
import torch

from benchmark.core.cells import load_cell
from benchmark.core.harness import run_cell

CELLS = ["cop20k_A.chain_k32", "cop20k_A.chain_k1", "amazon0302.pagerank_k1"]
SEED = 2**31 + 5


def tiny(name):
    cell = load_cell(name)
    cell.config["scale"] = 0.01
    cell.traffic["sample_range"] = [cell.traffic["sample_range"][0], 40]
    return cell


def run(name, wrap=None, trace=False):
    return run_cell(tiny(name), SEED, 0.3, trace, "cpu", wrap=wrap,
                    log=lambda *a: None)


@pytest.mark.parametrize("name", CELLS)
def test_the_program_is_correct(name):
    res = run(name)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert list(res)[-1] == "checks"
    names = set(res["metrics"])
    assert "setup_s" in names and len(names) >= 2
    for m in res["metrics"].values():
        assert m["value"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_the_traced_run_reads_its_per_layer_metrics(name):
    res = run(name, trace=True)
    assert res["correct"]
    assert "format_build_s" in res["metrics"]
    assert res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    control = importlib.import_module(
        f"benchmark.reference.{tiny(name).traffic['loop']}").control
    res = run(name, wrap=control)
    assert not res["correct"], res["checks"]


def _unchanged(out, x):
    return x


def _half_left_out(out, x):
    out = out.clone()
    out[: out.shape[0] // 2] = 0
    return out


def _one_altered(out, x):
    out = out.clone()
    flat = out.view(-1)
    flat[flat.numel() // 3] *= 1.01
    return out


FAULTS = {"unchanged": _unchanged, "half_left_out": _half_left_out,
          "one_altered": _one_altered}


def fault_wrap(loop, fault):
    if loop == "chain":
        def wrap(inputs, device):
            return lambda enc, body, dec: (
                enc, lambda x, op: fault(body(x, op), x), dec)
    else:
        def wrap(inputs, device):
            return lambda multiply: (lambda v: fault(multiply(v), v))
    return wrap


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(name, fault):
    loop = tiny(name).traffic["loop"]
    res = run(name, wrap=fault_wrap(loop, FAULTS[fault]))
    assert not res["correct"], res["checks"]
    assert res["failed"] > 0


def test_the_chain_keeps_its_samples():
    from benchmark.core.harness import make_inputs

    cell = tiny("cop20k_A.chain_k32")
    inputs = make_inputs(cell, SEED)
    loop = cell.loop_module().Loop(cell.config, cell.traffic, inputs, "cpu")
    import contextlib
    loop.setup(lambda name: contextlib.nullcontext())
    out = loop.window(0.2, lambda name: contextlib.nullcontext())
    s = loop.samples()
    assert len(s["start"]) == cell.traffic["start_steps"]
    idx = [i for i, _, _ in s["steps"]]
    assert idx[-1] == out["attempted"] - 1          # the window's last body
    assert all(x.shape == (inputs.v0.shape[0], 32) for _, x, _ in s["steps"])
    assert torch.is_tensor(torch.from_numpy(s["start"][0]))
