"""Card-only tests of the GNN training path: the custom-gradient SpMM
(``ops/autodiff.py``) through kernels B2 + B1 against the same autograd
through their plain versions, the hub route against the plain route, a
GCN training step's launches, the library yardstick and ``entry``.

Every test here needs an NVIDIA GPU and ``nvcc``; elsewhere each one
skips from inside the ``cuda`` fixture. The file imports no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda_gnn.py

Tolerance: the kernels and their plain versions sum the same bf16
hi + lo products in f32 in another order, so each result lies within
``1e-5 * cond + 1e-6`` of the plain one, ``cond`` the f64 product of
the absolute values (``|A| |v|``, or ``|A|^T |w|`` for a gradient).
"""

import numpy as np
import pytest
import torch

from sparsematrixmultiplicationmpi_tpu_torch.entry import entry
from sparsematrixmultiplicationmpi_tpu_torch.formats.hub import (
    HubExtracted,
)
from sparsematrixmultiplicationmpi_tpu_torch.formats.windowed import (
    CompactTiles, WindowedPairs,
)
from sparsematrixmultiplicationmpi_tpu_torch.io.generate import (
    cop20k_like, dc1_like, fem3d_csr, generate_fat_vector,
)
from sparsematrixmultiplicationmpi_tpu_torch.models import (
    gcn_loss, init_gcn, make_train_step, normalize_adjacency,
)
from sparsematrixmultiplicationmpi_tpu_torch.ops import cuda_windowed as cw
from sparsematrixmultiplicationmpi_tpu_torch.ops.auto import (
    auto_format, spmm_any,
)
from sparsematrixmultiplicationmpi_tpu_torch.ops.autodiff import (
    make_spmm, make_symmetric_spmm,
)
from sparsematrixmultiplicationmpi_tpu_torch.ops.library import (
    spmm_library, to_torch_sparse,
)
from sparsematrixmultiplicationmpi_tpu_torch.ops.oracle import spmm_host_f64

pytestmark = pytest.mark.gpu

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _within(got, want, cond):
    got = got.detach().cpu().double().numpy()
    want = want.detach().cpu().double().numpy()
    excess = np.abs(got - want) - (RTOL * cond + ATOL)
    assert excess.max() <= 0, float(np.abs(got - want).max())


def _abs_dense(csr):
    return np.abs(csr.to_dense().astype(np.float64))


def _windowed(csr, R):
    wp = WindowedPairs.from_csr(
        csr, block_rows=R, chunk_cols=128, reorder=None, pairs_per_step=16,
        beat_gather_margin=1e9, max_inflation=1e9)
    assert wp is not None
    return wp


def _value_and_grad(spmm, v, w, strided):
    v = v.clone().requires_grad_()
    out = spmm(v)
    if strided:
        (out.t() * w.t().contiguous()).sum().backward()
    else:
        (out * w).sum().backward()
    return out, v.grad


@pytest.mark.parametrize("R,make", [
    (128, lambda: fem3d_csr(512, 8192, seed=2)),
    (256, lambda: cop20k_like(scale=0.02)),
], ids=["R128", "R256"])
@pytest.mark.parametrize("k", [16, 128])
@pytest.mark.parametrize("strided", [False, True])
def test_autograd_through_b1_matches_its_plain_version(cuda, R, make, k,
                                                       strided):
    csr = make().astype(np.float32)
    host = _windowed(csr, R)
    card = host.to(cuda)
    assert isinstance(card.tiles_t, CompactTiles)
    n = csr.shape[0]
    v = generate_fat_vector(n, k, seed=1).astype(np.float32)
    w = generate_fat_vector(n, k, seed=2).astype(np.float32)
    cw.reset_launch_counts()
    out, grad = _value_and_grad(make_symmetric_spmm(card),
                                torch.from_numpy(v).to(cuda),
                                torch.from_numpy(w).to(cuda), strided)
    torch.cuda.synchronize()
    counts = cw.launch_counts()
    assert counts["B1"] == 2 and counts["B2"] == 2, counts
    pout, pgrad = _value_and_grad(make_symmetric_spmm(host.to("cpu")),
                                  torch.from_numpy(v), torch.from_numpy(w),
                                  strided)
    a = _abs_dense(csr)
    _within(out, pout, a @ np.abs(v))
    _within(grad, pgrad, a.T @ np.abs(w))


def test_general_spmm_gradient_on_card(cuda):
    csr = cop20k_like(scale=0.02).astype(np.float32)
    f = make_spmm(csr, device=cuda, k_nominal=128)
    fp = make_spmm(csr, device="cpu", k_nominal=128)
    v = generate_fat_vector(csr.shape[1], 16, seed=3).astype(np.float32)
    w = generate_fat_vector(csr.shape[0], 16, seed=4).astype(np.float32)
    out, grad = _value_and_grad(f, torch.from_numpy(v).to(cuda),
                                torch.from_numpy(w).to(cuda), False)
    pout, pgrad = _value_and_grad(fp, torch.from_numpy(v),
                                  torch.from_numpy(w), False)
    a = _abs_dense(csr)
    _within(out, pout, a @ np.abs(v))
    _within(grad, pgrad, a.T @ np.abs(w))


@pytest.mark.parametrize("k", [1, 8, 32])
def test_hub_route_matches_the_plain_route(cuda, k):
    csr = dc1_like(scale=0.05).astype(np.float32)
    host = auto_format(csr, allow_hub=True)
    assert isinstance(host, HubExtracted)
    v = generate_fat_vector(csr.shape[1], k, seed=k).astype(np.float32)
    got = spmm_any(host.to(cuda), torch.from_numpy(v).to(cuda))
    want = spmm_any(host.to("cpu"), torch.from_numpy(v))
    _within(got, want, _abs_dense(csr) @ np.abs(v))
    ref = spmm_host_f64(csr, v)
    assert np.abs(got.cpu().double().numpy() - ref).max() \
        <= 5e-3 * np.abs(ref).max()


def test_gcn_step_on_card_launches_b1_and_b2_four_times(cuda):
    csr = normalize_adjacency(cop20k_like(scale=0.02).astype(np.float32))
    host = _windowed(csr, 256)
    spmm = make_symmetric_spmm(host.to(cuda))
    n = csr.shape[0]
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(n, 32)).astype(np.float32)).to(
        cuda)
    labels = torch.from_numpy(rng.integers(0, 4, size=n)).to(cuda)
    mask = torch.ones(n, dtype=torch.bool, device=cuda)
    params = init_gcn(32, 128, 16, generator=torch.Generator().manual_seed(
        0), device=cuda)
    step = make_train_step(spmm, torch.optim.Adam(params, lr=1e-2))
    cw.reset_launch_counts()
    losses = [float(step(params, x, labels, mask)) for _ in range(3)]
    torch.cuda.synchronize()
    counts = cw.launch_counts()
    assert counts["B1"] == 12 and counts["B2"] == 12, counts
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    with torch.no_grad():
        assert torch.isfinite(gcn_loss(params, spmm, x, labels, mask))


def test_library_spmm_on_card(cuda):
    csr = dc1_like(scale=0.05).astype(np.float32)
    v = generate_fat_vector(csr.shape[1], 8, seed=5).astype(np.float32)
    a = to_torch_sparse(csr, device=cuda)
    assert a.is_cuda and a.layout == torch.sparse_csr
    got = spmm_library(a, torch.from_numpy(v).to(cuda))
    _within(got, torch.from_numpy(spmm_host_f64(csr, v)),
            _abs_dense(csr) @ np.abs(v))


def test_entry_on_card(cuda):
    forward, args = entry()
    assert args[2].is_cuda
    logits = forward(*args)
    assert logits.shape == (256, 4) and bool(torch.isfinite(logits).all())
