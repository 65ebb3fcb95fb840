"""The cost tables (``formats/cost.py``): which table prices which
device, the reference's table against the JAX package's constants, and
the gates a multiply reads from the dispatch table of its tensor's
device type."""

from __future__ import annotations

import dataclasses
import types

import numpy as np
import pytest
import torch

import sparsematrixmultiplicationmpi_tpu.formats.windowed as JW
import sparsematrixmultiplicationmpi_tpu.ops.auto as JA
import sparsematrixmultiplicationmpi_tpu.ops.ell as JE
from sparsematrixmultiplicationmpi_tpu.ops._gather_calib import (
    GATHER_CALIB_RECORDS as J_RECORDS,
)
import sparsematrixmultiplicationmpi_tpu_torch.formats.windowed as TW
import sparsematrixmultiplicationmpi_tpu_torch.io.generate as TG
import sparsematrixmultiplicationmpi_tpu_torch.ops.auto as TA
import sparsematrixmultiplicationmpi_tpu_torch.ops.ell as TE
import sparsematrixmultiplicationmpi_tpu_torch.ops.windowed as TOW
from sparsematrixmultiplicationmpi_tpu_torch.formats.cost import (
    H100, V5E, CostTable, cost_table_for, dispatch_table,
)

H100_NAME = "NVIDIA H100 80GB HBM3"


def _named(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: name)


def test_the_cpu_and_no_device_take_the_reference_table():
    assert cost_table_for(torch.device("cpu")) is V5E
    assert cost_table_for("cpu") is V5E
    assert cost_table_for(None) is V5E


@pytest.mark.parametrize("name", [H100_NAME, "NVIDIA H100 PCIe",
                                  "NVIDIA H100 NVL"])
def test_an_h100_takes_the_h100_table(monkeypatch, name):
    _named(monkeypatch, name)
    assert cost_table_for(torch.device("cuda", 0)) is H100
    assert cost_table_for("cuda") is H100


@pytest.mark.parametrize("name", ["NVIDIA A100-SXM4-80GB",
                                  "NVIDIA GeForce RTX 4090",
                                  "NVIDIA L4"])
def test_another_card_raises_naming_it(monkeypatch, name):
    _named(monkeypatch, name)
    with pytest.raises(ValueError, match=name):
        cost_table_for(torch.device("cuda", 0))
    # ... unless the caller says which table prices it.
    assert cost_table_for(torch.device("cuda", 0), H100) is H100
    assert cost_table_for(torch.device("cuda", 0), V5E) is V5E


def test_other_devices_raise():
    with pytest.raises(ValueError, match="meta"):
        cost_table_for(torch.device("meta"))


def test_the_dispatch_table_reads_the_device_type_only(monkeypatch):
    def no_lookup(device=None):
        raise AssertionError("dispatch looked up the card's name")

    monkeypatch.setattr(torch.cuda, "get_device_name", no_lookup)
    assert dispatch_table(torch.device("cuda", 0)) is H100
    assert dispatch_table("cuda") is H100
    assert dispatch_table("cpu") is V5E
    assert cost_table_for("cpu", H100) is H100  # an explicit table wins


#: V5E field -> the JAX package's module-level constant it carries.
JAX_NAMES = {
    "hbm_bw": (JW, "HBM_BW"), "gather_s_per_row": (JW, "GATHER_S_PER_ROW"),
    "tile_overhead_s": (JW, "TILE_OVERHEAD_S"),
    "tile_stream_bw": (JW, "TILE_STREAM_BW"),
    "production_pairs_per_step": (JW, "PRODUCTION_PAIRS_PER_STEP"),
    "tmulti_step_s": (JW, "TMULTI_STEP_S"),
    "tmulti_pair_s": (JW, "TMULTI_PAIR_S"),
    "spill_restore_s_per_row": (JW, "SPILL_RESTORE_S_PER_ROW"),
    "spill_frac_refuse": (JW, "SPILL_FRAC_REFUSE"),
    "kpad_min_k": (JW, "KPAD_MIN_K"),
    "dense_bytes_allowance": (JW, "DENSE_BYTES_ALLOWANCE"),
    "dense_bytes_hard_cap": (JW, "DENSE_BYTES_HARD_CAP"),
    "resident_slab_vmem_bytes": (JW, "RESIDENT_SLAB_VMEM_BYTES"),
    "coo_s_per_nnz": (JA, "COO_S_PER_NNZ"),
    "ell_s_per_slot": (JA, "ELL_S_PER_SLOT"),
    "spill_dma_gather": (JE, "SPILL_DMA_GATHER"),
}


@pytest.mark.parametrize("field", sorted(JAX_NAMES))
def test_v5e_is_the_jax_packages_constant(field):
    mod, name = JAX_NAMES[field]
    assert getattr(V5E, field) == getattr(mod, name)
    # The port's module name of the same constant stays the v5e value.
    port = {JW: TW, JA: TA, JE: TE}[mod]
    assert getattr(port, name) == getattr(mod, name)


def test_v5e_gather_records_and_structure_are_the_references():
    assert V5E.gather_calib_records == J_RECORDS
    assert V5E.max_kernel_block_rows == 128  # the reference's band gate
    assert (V5E.chain_floor, V5E.ctas, V5E.compact_tiles, V5E.entry_s,
            V5E.call_s, V5E.hub_s, V5E.beat_gather_margin) == (
                0.0, 1, False, 0.0, 0.0, 0.0, 0.8)
    assert V5E.band_bw == V5E.hbm_bw
    assert (V5E.band_k_cols, V5E.gather_coefs, V5E.one_shot_s) == (
        0, None, 0.0)


def test_h100_band_chunk_is_the_kernels():
    """The H100 table prices the band kernel's column chunk: the wrapper
    passes ``BAND_K_CHUNK`` to ``band_launch``, the table reads the band
    once per that many columns."""
    from sparsematrixmultiplicationmpi_tpu_torch.ops.cuda_banded import (
        BAND_K_CHUNK, MAX_KERNEL_BLOCK_ROWS,
    )

    assert H100.band_k_cols == BAND_K_CHUNK
    assert H100.max_kernel_block_rows <= MAX_KERNEL_BLOCK_ROWS


@pytest.mark.parametrize("k,passes", [(1, 1), (8, 1), (32, 1), (127, 1),
                                      (128, 1), (129, 2), (256, 2),
                                      (259, 3)])
def test_band_passes_and_stream_price_the_kernels_chunk(k, passes):
    """Through B5 (r <= 128) the band is read once per ``band_k_cols``
    columns at ``band_bw``; wider bands take the batched matmuls, one
    read at ``band_matmul_bw``; the reference's table reads once at its
    ``hbm_bw``."""
    from sparsematrixmultiplicationmpi_tpu_torch.formats.banded import (
        _band_passes, _band_stream_s,
    )

    nbytes = 186_187_776
    assert _band_passes(H100, 128, k) == passes
    assert _band_stream_s(H100, 128, k, nbytes) == pytest.approx(
        nbytes * passes / H100.band_bw)
    assert _band_passes(H100, 256, k) == 1
    assert _band_stream_s(H100, 256, k, nbytes) == pytest.approx(
        nbytes / H100.band_matmul_bw)
    assert _band_passes(V5E, 128, k) == _band_passes(V5E, 256, k) == 1
    assert _band_stream_s(V5E, 128, k, nbytes) == nbytes / V5E.band_bw
    assert V5E.band_spill_s == 0.0 and H100.band_spill_s >= 0.0


def test_h100_prices_chains_and_entries():
    assert H100.chain_floor > 0 and H100.ctas > 1 and H100.compact_tiles
    assert H100.entry_s > 0 and H100.gather_calib_records
    assert {r[0] for r in H100.gather_calib_records} == {"coo", "ell"}
    assert dataclasses.is_dataclass(H100) and isinstance(H100, CostTable)
    with pytest.raises(dataclasses.FrozenInstanceError):
        H100.ctas = 1


def test_the_gather_fit_is_cached_per_record_set():
    csr = TG.random_csr(400, 400, 3000, seed=3).astype(np.float32)
    v5e = TA.gather_class_estimates(csr, 8)
    h100 = TA.gather_class_estimates(csr, 8, cost_table=H100)
    assert v5e["coo"][0] != h100["coo"][0]
    assert TA.gather_class_estimates(csr, 8)["coo"][0] == v5e["coo"][0]
    assert TA.gather_class_estimates(csr, 8, cost_table=H100)["coo"][0] \
        == h100["coo"][0]


def _operand():
    csr = TG.banded_csr(512, 24, 8, seed=4).astype(np.float32)
    return TW.WindowedPairs.from_csr(
        csr, block_rows=128, chunk_cols=128, pairs_per_step=16,
        reorder=None, beat_gather_margin=1e9, max_inflation=1e9)


@pytest.mark.parametrize("name", [H100_NAME, "NVIDIA A100-SXM4-80GB"])
def test_the_narrow_k_gate_reads_the_dispatch_table(monkeypatch, name):
    _named(monkeypatch, name)
    wp = _operand()
    assert not TOW._takes_kernels(wp, 1, "cpu")  # the reference's 12
    assert TOW._takes_kernels(wp, 12, "cpu")
    # Every k on a CUDA tensor, whatever the card's name or the table
    # that built the operand.
    assert TOW._takes_kernels(wp, 1, "cuda")
    assert TOW._takes_kernels(wp, 3, torch.device("cuda", 0))


def test_the_spill_route_reads_the_dispatch_table(monkeypatch):
    v = torch.zeros((4, 8))
    card = types.SimpleNamespace(device=torch.device("cuda", 0))
    assert TE._dma_route(v, 8) is V5E.spill_dma_gather
    assert TE._dma_route(card, 8) is H100.spill_dma_gather
    assert not TE._dma_route(card, 129)  # B7 takes k <= 128
    monkeypatch.setattr(TE, "SPILL_DMA_GATHER", True)
    assert TE._dma_route(v, 8)
    assert not TE._dma_route(v, 129)


def test_a_bucketed_multiply_takes_either_route_per_call():
    csr = TG.random_csr(300, 200, 2500, seed=5).astype(np.float32)
    bell = TA.BucketedELL.from_csr(csr).to("cpu")
    v = torch.from_numpy(
        np.random.default_rng(0).normal(size=(200, 6)).astype(np.float32))
    take = TE.spmm_bucketed(bell, v, dma_gather=False)
    b7 = TE.spmm_bucketed(bell, v, dma_gather=True)  # its plain version
    assert torch.allclose(take, b7, rtol=1e-5, atol=1e-5)
    assert torch.equal(TE.spmm_bucketed(bell, v), take)


def test_the_h100_gather_estimate_is_its_records_on_the_anchors():
    for path, m, work, k, seconds, width in H100.gather_calib_records[::7]:
        est = TA._calibrated_gather_seconds(path, work, m, k, H100, width)
        assert est == pytest.approx(seconds, rel=0.05)


def test_the_gather_features_grow_with_the_work():
    coo = TA.gather_features("coo", 1000, 50, 8, width=40)
    assert coo == [1.0, 8000, 64000, 40]
    # The 4-wide path at k = 32, the scalar one at k = 6.
    assert TA.gather_features("ell", 1000, 50, 32, width=64) == [
        1.0, 4000, 1600, 64, 0.0]
    assert TA.gather_features("ell", 1000, 50, 6, width=64) == [
        1.0, 1000, 300, 0.0, 384]


def test_a_one_shot_caller_pays_the_windowed_encode_and_decode():
    csr = TG.banded_csr(2048, 24, 8, seed=6).astype(np.float32)
    table = dataclasses.replace(H100, one_shot_s=1.0)
    chain = dict((n, e) for n, e, _ in TA.route_candidates(
        csr, cost_table=table, k_nominal=8))
    once = dict((n, e) for n, e, _ in TA.route_candidates(
        csr, cost_table=table, k_nominal=8, one_shot=True))
    assert chain["windowed"] is not None
    assert once["windowed"] == pytest.approx(chain["windowed"] + 1.0)
    for name in ("bucketed_ell", "coo", "banded"):
        assert once[name] == chain[name]
    # No pick moves under the reference's table, whose one_shot_s is 0.
    assert TA.route_candidates(csr, k_nominal=8, one_shot=True)[2][1] == \
        TA.route_candidates(csr, k_nominal=8)[2][1]
