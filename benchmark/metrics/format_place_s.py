"""Seconds to move the picked operand to the device inside
``Auto.prepare``: the port's ``format.place`` phase (``.to(device)``,
ended by a synchronize; the card planes' build is inside it), host
clock, its total over the run."""


def read(run):
    try:
        from sparsematrixmultiplicationmpi_tpu_torch.utils.profiling import (
            snapshot,
        )
    except ImportError:  # a program without phases
        return None
    entry = snapshot().get("format.place")
    return entry["total_s"] if entry and entry["count"] else None
