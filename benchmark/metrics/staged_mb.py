"""Megabytes the gather route stages per multiply: the port's
``coo.staged_bytes`` counter (``ops/oracle.py::spmm_coo``, the gathered
rows and the products, each nnz x k), its total over its count in the
traced window, over 1e6 (``staged_mb.<loop>``)."""


def read(run):
    try:
        from sparsematrixmultiplicationmpi_tpu_torch.utils.profiling import (
            snapshot,
        )
    except ImportError:  # a program without a registry
        return None
    entry = snapshot().get("coo.staged_bytes")
    if not entry or not entry.get("count") or not entry.get("total"):
        # Never counted, or a program whose COO route has no counter.
        return None
    return entry["total"] / entry["count"] / 1e6
