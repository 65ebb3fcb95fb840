"""The gather route's spans and counter (``ops/oracle.py::spmm_coo``):
under ``torch.profiler`` each call records ``coo.gather``,
``coo.scatter`` and ``coo.staged_bytes`` (the two nnz x k intermediates);
with no profiler nothing is recorded and the route's arithmetic is what
it was. ``Auto`` priced by the card's table routes the dc1 stand-in to
COO, and its chain holds the f32 tier against a float64 dense product.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sparsematrixmultiplicationmpi_tpu_torch.formats.cost import H100
from sparsematrixmultiplicationmpi_tpu_torch.formats.matrix import COO
from sparsematrixmultiplicationmpi_tpu_torch.io.generate import (
    dc1_like, generate_fat_vector, powerlaw_csr,
)
from sparsematrixmultiplicationmpi_tpu_torch.ops.oracle import spmm_coo
from sparsematrixmultiplicationmpi_tpu_torch.parallel.strategies import Auto
from sparsematrixmultiplicationmpi_tpu_torch.utils import profiling as P
from sparsematrixmultiplicationmpi_tpu_torch.utils.compare import (
    are_matrices_equal, default_tolerance,
)

NAMES = ("coo.gather", "coo.scatter", "coo.staged_bytes")


@pytest.fixture(autouse=True)
def empty_registry():
    P.reset_spans()
    yield
    P.reset_spans()


def _operand(dtype=np.float32):
    csr = powerlaw_csr(300, 200, 2500, seed=5).astype(dtype)
    return csr.to_coo().to("cpu")


def _v(n, k, dtype=torch.float32):
    return torch.from_numpy(generate_fat_vector(n, k, seed=2)).to(dtype)


def _unspanned(coo, v):
    """The route as one expression, as it was before its spans."""
    prods = coo.values[:, None].to(v.dtype) * v.index_select(
        0, coo.col_indices)
    out = torch.zeros((coo.shape[0], v.shape[1]), dtype=v.dtype)
    return out.index_add_(0, coo.row_indices, prods)


@pytest.mark.parametrize("k,dtype", [(32, torch.float32), (6, torch.float32),
                                     (3, torch.float64)])
def test_each_call_records_both_spans_and_its_staged_bytes(k, dtype):
    coo = _operand(np.float32 if dtype == torch.float32 else np.float64)
    v = _v(coo.shape[1], k, dtype)
    calls = 3
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(calls):
            spmm_coo(coo, v)
    snap = P.snapshot()
    for name in ("coo.gather", "coo.scatter"):
        assert snap[name]["count"] == calls
        assert len(snap[name]["durations_s"]) == calls
        assert all(d > 0 for d in snap[name]["durations_s"])
    staged = snap["coo.staged_bytes"]
    item = torch.tensor([], dtype=dtype).element_size()
    assert staged == {"count": calls,
                      "total": calls * 2 * coo.nnz * k * item}
    regions = [e.key for e in prof.key_averages()]
    assert "coo.gather" in regions and "coo.scatter" in regions


def test_nothing_is_recorded_without_a_profiler():
    assert not P._recording()
    assert P.span("coo.gather") is P._NOOP
    assert P.span("coo.scatter") is P._NOOP
    coo = _operand()
    spmm_coo(coo, _v(coo.shape[1], 8))
    P.count("coo.staged_bytes", 10)
    assert P.snapshot() == {}


def test_a_counter_is_a_copy_in_the_snapshot_and_reset_clears_it():
    with profile(activities=[ProfilerActivity.CPU]):
        P.count("c", 4)
        P.count("c", 6)
    snap = P.snapshot()
    assert snap["c"] == {"count": 2, "total": 10}
    snap["c"]["total"] = 0
    assert P.snapshot()["c"]["total"] == 10
    P.reset_spans()
    assert P.snapshot() == {}


@pytest.mark.parametrize("traced", [False, True])
def test_the_arithmetic_is_the_unspanned_routes_bit_for_bit(traced):
    coo = _operand()
    v = _v(coo.shape[1], 32)
    want = _unspanned(coo, v)
    if traced:
        with profile(activities=[ProfilerActivity.CPU]):
            got = spmm_coo(coo, v)
    else:
        got = spmm_coo(coo, v)
    assert torch.equal(got, want)


def test_auto_on_the_card_table_takes_coo_for_dc1_and_holds_the_f32_tier():
    csr = dc1_like(seed=0, scale=0.02).astype(np.float32)
    strategy = Auto(cost_table=H100)
    op = strategy.prepare(csr, "cpu")
    assert isinstance(op, COO)
    m, n = csr.shape
    rows = np.repeat(np.arange(m), np.diff(csr.row_ptr))
    dense = np.zeros((m, n))
    np.add.at(dense, (rows, csr.col_indices), csr.values.astype(np.float64))
    dense = torch.from_numpy(dense)
    v0 = generate_fat_vector(n, 32, seed=4).astype(np.float32)
    enc, body, dec = strategy.chain_parts(op)
    x = enc(torch.from_numpy(v0), op)
    want = torch.from_numpy(v0.astype(np.float64))
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            x = body(x, op)
            want = torch.matmul(dense, want)
            got = dec(x, op)
            assert got.dtype == torch.float32
            assert are_matrices_equal(got.numpy(), want.numpy(),
                                      tolerance=default_tolerance(np.float32),
                                      relative=True)
    # Each body went through the gather route once.
    snap = P.snapshot()
    assert snap["coo.gather"]["count"] == 3
    assert snap["coo.staged_bytes"]["total"] == 3 * 2 * csr.nnz * 32 * 4
