"""Seconds of the rival builds inside ``Auto.prepare``: the port's
``format.rivals`` phase (``ops/auto.py::route_candidates``: the gather
estimates and their ``BucketedELL``, ``BandedBlocks.from_csr`` and the
COO), host clock, its total over the run."""


def read(run):
    try:
        from sparsematrixmultiplicationmpi_tpu_torch.utils.profiling import (
            snapshot,
        )
    except ImportError:  # a program without phases
        return None
    entry = snapshot().get("format.rivals")
    return entry["total_s"] if entry and entry["count"] else None
