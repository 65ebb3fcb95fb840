"""Train the flagship GCN whose aggregation is the port's SpMM
(counterpart of ``03_gcn_training.py``): the custom-gradient SpMM of
``ops/autodiff.py`` under ``torch.optim.Adam``.

Run: python examples/torch_03_gcn_training.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(
    0, os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
)

import torch

from sparsematrixmultiplicationmpi_tpu_torch.formats.matrix import (
    BucketedELL,
)
from sparsematrixmultiplicationmpi_tpu_torch.models import (
    gcn_forward, init_gcn, make_train_step, normalize_adjacency,
    synthetic_node_classification,
)
from sparsematrixmultiplicationmpi_tpu_torch.ops.autodiff import (
    make_symmetric_spmm,
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device: pass --device cpu", file=sys.stderr)
        return 1
    dev = torch.device(args.device)
    n, n_features, hidden, n_classes = 2048, 32, 64, 5
    adj, x, labels, mask = synthetic_node_classification(
        n, n_features, n_classes, seed=0)
    bell = BucketedELL.from_csr(normalize_adjacency(adj)).astype(
        torch.float32).to(dev)
    spmm = make_symmetric_spmm(bell)
    x, labels, mask = (torch.from_numpy(a).to(dev) for a in (x, labels, mask))

    params = init_gcn(n_features, hidden, n_classes,
                      generator=torch.Generator().manual_seed(0),
                      device=dev)
    step = make_train_step(spmm, torch.optim.Adam(params, lr=1e-2))

    def accuracy(sel):
        with torch.no_grad():
            preds = gcn_forward(params, spmm, x).argmax(dim=1)
        return float((preds == labels)[sel].float().mean())

    first = None
    for epoch in range(100):
        loss = float(step(params, x, labels, mask))
        first = loss if first is None else first
        if epoch % 20 == 0:
            print(f"epoch {epoch:3d}  loss {loss:.4f}  "
                  f"acc {accuracy(mask):.3f}")
    print(f"held-out accuracy: {accuracy(~mask):.3f}")
    return 0 if loss < first else 1


if __name__ == "__main__":
    sys.exit(main())
