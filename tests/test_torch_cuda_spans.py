"""Card-only tests of the port's spans and phases (``utils/profiling.py``):
a chain body at k = 1 pads its width to 8 inside one ``windowed.pad``
span, a body at k = 32 (the transposed chain) enters none, and each
``WindowedPairs.to("cuda")`` builds its card planes inside one
``format.card_planes`` phase.

Every test skips without a CUDA device. The file imports no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda_spans.py
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sparsematrixmultiplicationmpi_tpu_torch.formats.windowed import (
    WindowedPairs,
)
from sparsematrixmultiplicationmpi_tpu_torch.io.generate import (
    banded_csr, generate_fat_vector,
)
from sparsematrixmultiplicationmpi_tpu_torch.parallel.strategies import Auto
from sparsematrixmultiplicationmpi_tpu_torch.utils import profiling as P

pytestmark = pytest.mark.gpu

BODIES = 5


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    P.reset_spans()
    yield torch.device("cuda", 0)
    P.reset_spans()


def _host():
    csr = banded_csr(512, 24, 8, seed=4).astype(np.float32)
    return WindowedPairs.from_csr(
        csr, block_rows=128, chunk_cols=128, pairs_per_step=16,
        reorder=None, beat_gather_margin=1e9, max_inflation=1e9)


def _bodies(wp, k, dev):
    enc, body, dec = Auto().chain_parts(wp)
    v = torch.from_numpy(generate_fat_vector(512, k, seed=k).astype(
        np.float32)).to(dev)
    x = enc(v, wp)
    for _ in range(BODIES):
        x = body(x, wp)
    out = dec(x, wp)
    torch.cuda.synchronize(dev)
    return out


@pytest.mark.parametrize("k,pads", [(1, BODIES), (32, 0)])
def test_one_pad_a_body_at_narrow_k_none_at_k32(cuda, tmp_path, k, pads):
    wp = _host().to(cuda)
    untraced = _bodies(wp, k, cuda)
    assert "windowed.pad" not in P.snapshot()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        assert P._recording()
        traced = _bodies(wp, k, cuda)
    assert torch.equal(traced, untraced)
    got = P.snapshot().get("windowed.pad", {"count": 0, "durations_s": []})
    assert got["count"] == pads
    assert len(got["durations_s"]) == pads
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())
    if isinstance(events, dict):
        events = events["traceEvents"]
    assert sum(e.get("cat") == "user_annotation"
               and e.get("name") == "windowed.pad" for e in events) == pads


def test_one_card_planes_phase_a_cuda_copy(cuda):
    host = _host()
    host.to(cuda)
    assert P.snapshot()["format.card_planes"]["count"] == 1
    host.to(cuda)
    assert P.snapshot()["format.card_planes"]["count"] == 2
    host.to("cpu")
    assert P.snapshot()["format.card_planes"]["count"] == 2


def test_prepare_on_the_card_records_its_phases(cuda):
    csr = banded_csr(2048, 24, 8, seed=6).astype(np.float32)
    op = Auto().prepare(csr, cuda)
    snap = P.snapshot()
    for name in ("format.windowed", "format.rivals", "format.place"):
        assert snap[name]["count"] == 1, name
    windowed = isinstance(op, WindowedPairs)
    assert snap.get("format.card_planes", {"count": 0})["count"] == windowed
    if windowed:
        # Nested: the card planes are built inside the move to the card.
        assert (snap["format.card_planes"]["total_s"]
                <= snap["format.place"]["total_s"])
