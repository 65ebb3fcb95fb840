"""Host milliseconds of one convergence read of PageRank, the median of
the port's ``pagerank.converged`` span (``models/pagerank.py``): the
host reads ``delta > tol`` back and waits there for the iteration's
work on the device (``sync_ms.<loop>``). Spans record only while the
profiler does, so this is the traced window's."""

import statistics


def read(run):
    try:
        from sparsematrixmultiplicationmpi_tpu_torch.utils.profiling import (
            snapshot,
        )
    except ImportError:  # a program without spans
        return None
    durations = snapshot().get("pagerank.converged", {}).get("durations_s")
    return statistics.median(durations) * 1e3 if durations else None
