"""Consumer loops, one module per kind; a traffic file names its kind
under ``loop`` and the harness imports ``benchmark.loops.<loop>``."""
