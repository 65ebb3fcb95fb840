"""Host milliseconds of the zero-pad of a narrow ``k`` to a multiple of 8
on the card, the median of the port's ``windowed.pad`` span
(``ops/windowed.py::spmm_windowed_core``; ``pad_ms.<loop>``)."""

import statistics


def read(run):
    try:
        from sparsematrixmultiplicationmpi_tpu_torch.utils.profiling import (
            snapshot,
        )
    except ImportError:  # a program without spans
        return None
    durations = snapshot().get("windowed.pad", {}).get("durations_s")
    return statistics.median(durations) * 1e3 if durations else None
