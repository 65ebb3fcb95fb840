"""Seconds to build a windowed operand's card planes on the host: the
port's ``format.card_planes`` phase (``WindowedPairs.to``, inside
``format.place``), host clock, its total over the run."""


def read(run):
    try:
        from sparsematrixmultiplicationmpi_tpu_torch.utils.profiling import (
            snapshot,
        )
    except ImportError:  # a program without phases
        return None
    entry = snapshot().get("format.card_planes")
    return entry["total_s"] if entry and entry["count"] else None
