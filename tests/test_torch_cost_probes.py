"""The card's cost-model probes (``scripts/``) on the CPU at a small
size: each runs end to end, checks its results against the f64 oracle
and writes its JSON; a card run without CUDA is refused. And the H100
table holds what the card's probes wrote under ``results/h100/``."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from sparsematrixmultiplicationmpi_tpu_torch.formats import _gather_calib_h100
from sparsematrixmultiplicationmpi_tpu_torch.formats.banded import _band_passes
from sparsematrixmultiplicationmpi_tpu_torch.formats.cost import H100
from sparsematrixmultiplicationmpi_tpu_torch.scripts import (
    _common, check_cost_constants, exp_auto_threshold, exp_gather_calib3,
    exp_hub_dc1, exp_kpad_windowed, exp_spill_gather, fit_probe17,
)

RESULTS = os.path.join(_common.ROOT, "results", "h100")


def _run(main, tmp_path, *extra):
    assert main(["--device", "cpu", "--out-dir", str(tmp_path), *extra]) == 0


def _load(tmp_path, name):
    with open(tmp_path / f"{name}_cpu.json") as f:
        data = json.load(f)
    assert data["device"] == "cpu" and data["hardware"] == "cpu"
    return data


@pytest.mark.parametrize("main", [
    exp_gather_calib3.main, fit_probe17.main, exp_kpad_windowed.main,
    exp_spill_gather.main, exp_auto_threshold.main, exp_hub_dc1.main,
    check_cost_constants.main])
def test_a_card_run_without_cuda_is_refused(main, capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    assert main([]) == 1
    assert "needs a CUDA device" in capsys.readouterr().err


def test_gather_calib3_on_the_cpu(tmp_path):
    _run(exp_gather_calib3.main, tmp_path, "--scale", "0.01", "--matrices",
         "cage4_like", "powerlaw_100k", "--ks", "1", "6")
    recs = _load(tmp_path, "gather_calib3")["records"]
    assert len(recs) == 2 * 2 * 3
    assert {r["path"] for r in recs} == {"coo", "ell_take", "ell_b7"}
    assert all(r["seconds"] > 0 for r in recs)
    with pytest.raises(ValueError, match="not a card"):
        exp_gather_calib3.render(str(tmp_path / "gather_calib3_cpu.json"),
                                 "b7")


def test_fit_probe17_on_the_cpu(tmp_path):
    _run(fit_probe17.main, tmp_path, "--scale", "0.02", "--ks", "8", "32")
    data = _load(tmp_path, "probe17_fit")
    ops = {(r["matrix"], r["R"], r["C"], r["U"]) for r in data["records"]}
    assert ops == set(fit_probe17.operands())
    fit = data["fit"]
    assert set(fit["constants"]) >= set(fit_probe17.NAMES) | {
        "chain_floor", "tile_overhead_s", "call_s"}
    assert fit["constants"]["chain_floor"] == 1.0
    for r in data["records"]:
        assert sum(r["block_pairs"]) == r["pairs"]
        assert sum(r["block_entries"]) == r["entries"]


def test_kpad_windowed_on_the_cpu(tmp_path):
    _run(exp_kpad_windowed.main, tmp_path, "--scale", "0.03", "--ks", "1",
         "12")
    data = _load(tmp_path, "kpad_windowed")
    assert {r["operand"] for r in data["rows"]} == {
        "u16_f32", "u2_f32", "u2_bf16"}
    assert data["kpad_min_k"] in (1, 12, 13)


def test_kpad_decision():
    rows = [{"k": k, "kernels_s": 1.0, "plain_s": p}
            for k, p in ((1, 0.5), (3, 2.0), (6, 2.0))]
    assert exp_kpad_windowed.decide(rows) == 3
    assert exp_kpad_windowed.decide(rows[1:]) == 1
    assert exp_kpad_windowed.decide(rows[:1]) == 2


def test_spill_gather_on_the_cpu(tmp_path):
    _run(exp_spill_gather.main, tmp_path, "--scale", "0.03")
    data = _load(tmp_path, "spill_gather")
    assert data["rows"] and data["gather_s_per_row"] > 0
    assert isinstance(data["spill_dma_gather"], bool)


def test_auto_threshold_on_the_cpu(tmp_path):
    _run(exp_auto_threshold.main, tmp_path, "--scale", "0.05")
    data = _load(tmp_path, "auto_threshold")
    assert len(data["ladder"]) == len(exp_auto_threshold.FRACS)
    for row in data["ladder"]:
        assert set(row["measured_ms"]) == set(row["model_est_ms"])
        assert row["model_matches"] == (
            row["measured_winner"] == row["model_winner"])


def test_auto_threshold_decisions():
    rows = [{"block_rows": r, "k": k, "band_bytes": 8.0 * r, "m": 0,
             "spill": r == 128, "banded_s": 1.0,
             **({"b5_s": b5, "priced_rest_s": 0.1} if r <= 128 else {})}
            for r, k, b5 in ((128, 1, 0.5), (128, 32, 2.0), (256, 1, None),
                             (512, 1, None))]
    shots = [{"class": "banded", "block_rows": 128, "spill": False,
              "band_bytes": 1024.0, "m": 0, "k": k, "body_s": s}
             for k, s in ((1, 1.0), (32, 2.0), (8, 4.0))]
    got = exp_auto_threshold.gate_decision(rows, shots)
    assert got["max_kernel_block_rows"] == 128
    assert got["b5_loses_at_k"] == [32]
    call = H100.call_s
    # The matmuls' rate over the spill-free builds past the gate; B5's
    # over its chain bodies, the band read once per band_k_cols columns.
    assert got["band_matmul_bw"] == pytest.approx(
        (2048 / (1.0 - call) + 4096 / (1.0 - call)) / 2)
    assert got["band_bw"] == pytest.approx(np.median(
        [1024 * _band_passes(H100, 128, x["k"]) / (x["body_s"] - call)
         for x in shots]))
    # What the spilled B5 rows measure beyond the band at that rate and
    # their other priced terms.
    assert got["band_spill_s"] == pytest.approx(np.median(
        [x["b5_s"] - 1024 * _band_passes(H100, 128, x["k"])
         / got["band_bw"] - 0.1 for x in rows if "b5_s" in x]))
    shots = [{"class": c, "one_shot_s": a, "body_s": b}
             for c, a, b in (("windowed", 3.0, 1.0), ("windowed", 2.0, 1.5),
                             ("windowed", 4.0, 1.0), ("banded", 9.0, 1.0))]
    assert exp_auto_threshold.one_shot_decision(shots) == {"one_shot_s": 2.0}


def test_hub_dc1_on_the_cpu(tmp_path):
    _run(exp_hub_dc1.main, tmp_path, "--scale", "0.1")
    data = _load(tmp_path, "hub_dc1")
    assert data["hubs"] > 0 and set(data["ks"]) == {"6", "32"}
    assert data["hub_s"] >= 0


def test_cost_constants_compare():
    got = {name: getattr(H100, name) for name in check_cost_constants.CHECKED}
    assert all(r["ok"] for r in check_cost_constants.compare(got, 0.3))
    got["entry_s"] *= 1.5
    bad = [r["constant"] for r in check_cost_constants.compare(got, 0.3)
           if not r["ok"]]
    assert bad == ["entry_s"]


# ---- the H100 table is what the card's probes wrote ----------------------

def _card(name):
    with open(os.path.join(RESULTS, f"{name}.json")) as f:
        data = json.load(f)
    assert data["device"] == "cuda" and "H100" in data["hardware"]
    return data


def test_h100_gather_records_are_the_cards():
    with open(_gather_calib_h100.__file__) as f:
        committed = f.read()
    route = "b7" if H100.spill_dma_gather else "take"
    assert committed == exp_gather_calib3.render(
        os.path.join(RESULTS, "gather_calib3.json"), route)
    assert H100.gather_calib_records == \
        _gather_calib_h100.GATHER_CALIB_RECORDS_H100


def test_h100_windowed_constants_are_the_fit():
    fit = _card("probe17_fit")["fit"]
    for name, value in fit["constants"].items():
        assert getattr(H100, name) == pytest.approx(value, rel=1e-3), name
    assert H100.production_pairs_per_step == fit["production_pairs_per_step"]


def test_h100_gates_are_the_probes_decisions():
    spill = _card("spill_gather")
    assert H100.spill_dma_gather is spill["spill_dma_gather"]
    for name in ("gather_s_per_row", "spill_restore_s_per_row"):
        assert getattr(H100, name) == pytest.approx(spill[name], rel=1e-3)
    assert H100.kpad_min_k == _card("kpad_windowed")["kpad_min_k"]
    thr = _card("auto_threshold")
    assert H100.max_kernel_block_rows == thr["max_kernel_block_rows"]
    assert H100.band_bw == pytest.approx(thr["band_bw"], rel=1e-3)
    assert H100.band_spill_s == pytest.approx(thr["band_spill_s"],
                                              rel=1e-3)
    assert thr["b5_loses_at_k"] == []
    assert H100.one_shot_s == pytest.approx(thr["one_shot_s"], rel=1e-3)
    assert H100.hub_s == pytest.approx(_card("hub_dc1")["hub_s"], rel=1e-3,
                                       abs=1e-9)
    check = _card("cost_constants_check")
    assert H100.hbm_bw == pytest.approx(next(
        r["measured"] for r in check["constants"]
        if r["constant"] == "hbm_bw"), rel=0.3)
