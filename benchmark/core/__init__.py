"""The harness core shared by every cell: finding a cell's files by name,
the run itself, timing, the profiler's trace and the byte floors."""
