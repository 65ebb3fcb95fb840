"""Seconds of the windowed build inside ``Auto.prepare``: the port's
``format.windowed`` phase (``ops/auto.py::route_candidates``,
``WindowedPairs.from_csr``: reordering, the tiling search, the planes),
host clock, its total over the run."""


def read(run):
    try:
        from sparsematrixmultiplicationmpi_tpu_torch.utils.profiling import (
            snapshot,
        )
    except ImportError:  # a program without phases
        return None
    entry = snapshot().get("format.windowed")
    return entry["total_s"] if entry and entry["count"] else None
