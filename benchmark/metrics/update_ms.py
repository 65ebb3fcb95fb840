"""Host milliseconds to issue one PageRank update, the median of the
port's ``pagerank.update`` span (``models/pagerank.py``): scale and
teleport, normalise, the largest change; the multiply is outside it
(``update_ms.<loop>``)."""

import statistics


def read(run):
    try:
        from sparsematrixmultiplicationmpi_tpu_torch.utils.profiling import (
            snapshot,
        )
    except ImportError:  # a program without spans
        return None
    durations = snapshot().get("pagerank.update", {}).get("durations_s")
    return statistics.median(durations) * 1e3 if durations else None
